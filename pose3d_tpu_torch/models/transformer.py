"""Transformer (ViT-based) lifting model (counterpart of
``pose3d_tpu/models/transformer.py``).

Image stream: a ViT over the 4-channel [RGB | depth] input (patch 16,
512×512 → 1024 tokens + CLS). Heatmap stream: Gaussian heatmaps → conv
patch-embed + learned positions. Then bidirectional cross-modal fusion
blocks, a final encoder over [CLS | image | heatmap] tokens, LayerNorm and
the CLS → MLP regression head.

Modules and parameters carry the reference project's names, the keys that
``pose3d_tpu.compat_export.export_reference_transformer`` writes, so a
``pose3d-convert --to-torch`` checkpoint strict-loads.

Precision: parameters stay fp32 (master weights) and are cast to the
compute dtype at use, as flax ``Dense(dtype=bf16)`` casts input and kernel.
LayerNorm runs in fp32 (eps 1e-6) and rounds its output to the compute
dtype; the head's final Linear runs in fp32.

Dropout sits where the JAX model has it: after each attention's output
projection, after the MLP's hidden activation and after its output (rate
``transformer_dropout_rate`` in the fusion and final blocks, 0 in the ViT),
on the ViT's and the final encoder's tokens after their positions are added,
and after each hidden activation of the head (``regression_dropout``).
``transformer_attention_dropout_rate`` is not applied inside attention, as
in the JAX package. Masks are drawn only in train mode (``model.train()``),
from the ``generator`` the caller passes to ``forward``; in eval mode the
forward is the inference forward, untouched.

``remat`` recomputes each ViT block, fusion block and final encoder block
in the backward pass (``torch.utils.checkpoint``) instead of keeping its
activations, as the JAX model's ``nn.remat`` does; the parameter names do
not change. The recomputation draws the block's dropout masks again from
the generator state the block first started from (:func:`_remat`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pose3d_tpu_torch.core.config import TransformerModelConfig
from pose3d_tpu_torch.models.common import (
    PoseRegressionHead,
    dropout,
    linear,
)
from pose3d_tpu_torch.ops.activations import get_activation
from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.ops.heatmap import gaussian_heatmaps

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype) -> torch.Tensor:
    """fp32 statistics and affine, output in ``dtype`` (flax LayerNorm
    with dtype=bf16, param_dtype=fp32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, LN_EPS).to(dtype)


def _ln(dim, device):
    return nn.LayerNorm(dim, eps=LN_EPS, device=device)


def _attend(q_in, kv_in, w_in, b_in, out: nn.Linear, heads: int, dtype,
            impl: str, rate: float, gen):
    """Packed [q; k; v] projection (rows head-major: h·hd + j) → attention
    → output projection. Self-attention projects once and hands the kernel
    strided q/k/v views of the one [B, T, 3, H, hd] result."""
    B, Tq, D = q_in.shape
    hd = D // heads
    if kv_in is q_in:
        qkv = F.linear(q_in.to(dtype), w_in.to(dtype), b_in.to(dtype))
        q, k, v = qkv.view(B, Tq, 3, heads, hd).unbind(2)
    else:
        q = F.linear(q_in.to(dtype), w_in[:D].to(dtype), b_in[:D].to(dtype))
        q = q.view(B, Tq, heads, hd)
        kv = F.linear(kv_in.to(dtype), w_in[D:].to(dtype), b_in[D:].to(dtype))
        k, v = kv.view(B, kv_in.shape[1], 2, heads, hd).unbind(2)
    o = dot_product_attention(q, k, v, impl=impl)
    return dropout(linear(o.reshape(B, Tq, D), out, dtype), rate, gen)


def _remat(fn, gen: Optional[torch.Generator], *tensors):
    """``fn(*tensors)`` under ``torch.utils.checkpoint``. The masks of
    ``gen`` must come out the same in the recomputation, and checkpoint
    restores only the global default generators, not a caller's: so the
    generator's state before the first run is kept, set again for the
    recomputation, and the state the recomputation found is put back after
    it, leaving the generator where the forward pass left it."""
    if gen is None:
        return checkpoint(fn, *tensors, use_reentrant=False,
                          preserve_rng_state=False)
    start = gen.get_state()
    runs = 0

    def run(*xs):
        nonlocal runs
        runs += 1
        if runs == 1:
            return fn(*xs)
        found = gen.get_state()
        gen.set_state(start)
        try:
            return fn(*xs)
        finally:
            gen.set_state(found)
    # no global generator is drawn from: every mask comes from gen
    return checkpoint(run, *tensors, use_reentrant=False,
                      preserve_rng_state=False)


class TimmAttention(nn.Module):
    """ViT-block attention with timm's names: ``qkv`` and ``proj``;
    output dropout at ``dropout``."""

    def __init__(self, dim: int, heads: int, *, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.heads = heads
        self.rate = dropout
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, q_in, kv_in, dtype, impl, gen=None):
        return _attend(q_in, kv_in, self.qkv.weight, self.qkv.bias,
                       self.proj, self.heads, dtype, impl, self.rate, gen)


class MultiHeadAttention(nn.Module):
    """Attention with ``nn.MultiheadAttention``'s parameter names
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``); computed by
    :func:`dot_product_attention`, not by ``nn.MultiheadAttention``;
    output dropout at ``dropout``."""

    def __init__(self, dim: int, heads: int, *, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.heads = heads
        self.rate = dropout
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, q_in, kv_in, dtype, impl, gen=None):
        return _attend(q_in, kv_in, self.in_proj_weight, self.in_proj_bias,
                       self.out_proj, self.heads, dtype, impl, self.rate, gen)


class Mlp(nn.Module):
    """Linear → activation → dropout → Linear → dropout. ``names`` are the
    two Linears' keys: ("fc1", "fc2") in timm blocks, ("0", "3") in the
    reference's Sequential[Linear, act, Dropout, Linear, Dropout]."""

    def __init__(self, dim: int, ratio: float, activation: str,
                 names=("0", "3"), *, dropout: float = 0.0, device=None):
        super().__init__()
        hidden = int(dim * ratio)
        self.names = names
        self.rate = dropout
        for name, (i, o) in zip(names, ((dim, hidden), (hidden, dim))):
            self.add_module(name, nn.Linear(i, o, device=device))
        self.act = get_activation(activation)

    def forward(self, x, dtype, gen=None):
        fc1, fc2 = (getattr(self, n) for n in self.names)
        h = dropout(self.act(linear(x, fc1, dtype)), self.rate, gen)
        return dropout(linear(h, fc2, dtype), self.rate, gen)


class TransformerEncoderBlock(nn.Module):
    """Pre-LN self-attention block. ``timm=True`` uses timm's ViT names
    (``attn.qkv``/``attn.proj``, ``mlp.fc1``/``mlp.fc2``), otherwise the
    reference encoder's (``attn.in_proj_weight``, ``mlp.0``/``mlp.3``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 activation: str, *, timm: bool, dropout: float = 0.0,
                 device=None):
        super().__init__()
        Attn = TimmAttention if timm else MultiHeadAttention
        self.norm1 = _ln(dim, device)
        self.attn = Attn(dim, heads, dropout=dropout, device=device)
        self.norm2 = _ln(dim, device)
        self.mlp = Mlp(dim, mlp_ratio, activation,
                       ("fc1", "fc2") if timm else ("0", "3"),
                       dropout=dropout, device=device)

    def forward(self, x, dtype, impl, gen=None):
        y = layer_norm(x, self.norm1, dtype)
        x = x + self.attn(y, y, dtype, impl, gen)
        return x + self.mlp(layer_norm(x, self.norm2, dtype), dtype, gen)


class CrossModalFusionBlock(nn.Module):
    """Image tokens attend to heatmap tokens, then heatmap tokens attend to
    the updated image tokens, then one MLP per stream (pre-LN)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 activation: str, *, dropout: float = 0.0, device=None):
        super().__init__()
        kw = dict(dropout=dropout, device=device)
        self.norm_img_q = _ln(dim, device)
        self.norm_hm_kv = _ln(dim, device)
        self.cross_attn_img_to_hm = MultiHeadAttention(dim, heads, **kw)
        self.norm_hm_q = _ln(dim, device)
        self.norm_img_kv = _ln(dim, device)
        self.cross_attn_hm_to_img = MultiHeadAttention(dim, heads, **kw)
        self.norm_img_mlp = _ln(dim, device)
        self.mlp_img = Mlp(dim, mlp_ratio, activation, **kw)
        self.norm_hm_mlp = _ln(dim, device)
        self.mlp_hm = Mlp(dim, mlp_ratio, activation, **kw)

    def forward(self, x_img, x_hm, dtype, impl, gen=None):
        x_img = x_img + self.cross_attn_img_to_hm(
            layer_norm(x_img, self.norm_img_q, dtype),
            layer_norm(x_hm, self.norm_hm_kv, dtype), dtype, impl, gen)
        x_hm = x_hm + self.cross_attn_hm_to_img(
            layer_norm(x_hm, self.norm_hm_q, dtype),
            layer_norm(x_img, self.norm_img_kv, dtype), dtype, impl, gen)
        x_img = x_img + self.mlp_img(
            layer_norm(x_img, self.norm_img_mlp, dtype), dtype, gen)
        x_hm = x_hm + self.mlp_hm(
            layer_norm(x_hm, self.norm_hm_mlp, dtype), dtype, gen)
        return x_img, x_hm


class PatchEmbedding(nn.Module):
    """Patch projection: NHWC [B, H, W, C] → [B, N, D], tokens in row-major
    patch order (as flax's NHWC reshape). The stride-p, p×p conv
    ``proj`` is applied as the matmul it is: each patch flattened in the
    weight's (C, kh, kw) order, times the [D, C·p·p] weight. (oneDNN's
    bf16 conv gives wrong results for this shape on some CPUs.)"""

    def __init__(self, in_ch: int, dim: int, patch: int, *, device=None):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_ch, dim, patch, stride=patch, device=device)

    def forward(self, x, dtype):
        p = self.patch
        B, H, W, C = x.shape
        if H % p or W % p:
            raise ValueError(f"Image dims {H}x{W} must be divisible by "
                             f"patch size {p}.")
        patches = (x.to(dtype).view(B, H // p, p, W // p, p, C)
                   .permute(0, 1, 3, 5, 2, 4)
                   .reshape(B, (H // p) * (W // p), C * p * p))
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(patches, w.to(dtype), self.proj.bias.to(dtype))


class ViTBackbone(nn.Module):
    """Patch-embed → [CLS] + positions → token dropout → pre-LN blocks →
    LayerNorm, with timm ``VisionTransformer`` names. ``dropout`` is the
    token and block rate (0 in the lifter, as in the JAX package)."""

    def __init__(self, in_ch: int, image_size, dim: int, depth: int,
                 heads: int, patch: int, *, dropout: float = 0.0,
                 remat: bool = False, device=None):
        super().__init__()
        self.rate = dropout
        self.remat = remat
        n = (image_size[0] // patch) * (image_size[1] // patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, 1 + n, dim, device=device))
        self.patch_embed = PatchEmbedding(in_ch, dim, patch, device=device)
        self.blocks = nn.ModuleList(
            TransformerEncoderBlock(dim, heads, 4.0, "gelu", timm=True,
                                    dropout=dropout, device=device)
            for _ in range(depth)
        )
        self.norm = _ln(dim, device)

    def forward(self, x, dtype, impl, gen=None):
        tokens = self.patch_embed(x, dtype)
        B, _, D = tokens.shape
        cls = self.cls_token.to(dtype).expand(B, 1, D)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(dtype)
        tokens = dropout(tokens, self.rate, gen)
        for blk in self.blocks:
            tokens = _block(blk, self.remat, gen, tokens, dtype=dtype,
                            impl=impl)
        return layer_norm(tokens, self.norm, dtype)


def _block(blk: nn.Module, remat: bool, gen, *tensors, **kw):
    """``blk(*tensors, **kw, gen=gen)``, rematerialised when ``remat`` and
    gradients are being recorded."""
    if not (remat and torch.is_grad_enabled()):
        return blk(*tensors, gen=gen, **kw)
    return _remat(lambda *xs: blk(*xs, gen=gen, **kw), gen, *tensors)


class HeatmapGrid(nn.Module):
    """Holds the reference heatmap generator's meshgrid buffers
    (x_grid[i, j] = j, y_grid[i, j] = i) so checkpoints strict-load; the
    heatmaps themselves come from the separable
    :func:`gaussian_heatmaps`. Filled by :meth:`reset_buffers`, as the
    parameters are by ``build_model``."""

    def __init__(self, size: int, *, device=None):
        super().__init__()
        self.size = size
        self.register_buffer("x_grid", torch.empty(size, size, device=device))
        self.register_buffer("y_grid", torch.empty(size, size, device=device))

    @torch.no_grad()
    def reset_buffers(self):
        c = torch.arange(self.size, dtype=torch.float32,
                         device=self.x_grid.device)
        y, x = torch.meshgrid(c, c, indexing="ij")
        self.x_grid.copy_(x)
        self.y_grid.copy_(y)


class TransformerPoseEstimation(nn.Module):
    """forward(image [B,H,W,3], depth [B,H,W,1], keypoints_2d [B,J,2],
    generator=None) → joints_3d [B,J,3] fp32.

    ``dtype`` is the compute dtype. ``attention_impl`` is passed to
    :func:`dot_product_attention`: "auto" (kernels on CUDA, plain versions
    on CPU) or "reference" (plain versions everywhere). In train mode
    with a dropout rate above 0, ``generator`` (a ``torch.Generator`` on
    the model's device) is required and draws every dropout mask.
    ``remat`` rematerialises the encoder and fusion blocks (module
    docstring)."""

    def __init__(self, config: TransformerModelConfig, *,
                 dtype=torch.bfloat16, attention_impl: str = "auto",
                 remat: bool = False, device=None):
        super().__init__()
        cfg = config
        D = cfg.transformer_embed_dim
        self.config = cfg
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.remat = remat
        hp = cfg.heatmap_patch_size
        n_hm = (cfg.heatmap_size // hp) ** 2
        n_img = ((cfg.image_size[0] // cfg.vit_patch_size)
                 * (cfg.image_size[1] // cfg.vit_patch_size))
        self.pos_embed_hm = nn.Parameter(
            torch.empty(1, n_hm, D, device=device))
        self.final_cls_token = nn.Parameter(
            torch.empty(1, 1, D, device=device))
        self.final_pos_embed = nn.Parameter(
            torch.empty(1, 1 + n_img + n_hm, D, device=device))
        rate = cfg.transformer_dropout_rate
        self.vit_backbone = ViTBackbone(
            cfg.image_in_channels, cfg.image_size, D, cfg.vit_depth,
            cfg.vit_heads, cfg.vit_patch_size, dropout=0.0, remat=remat,
            device=device)
        self.heatmap_generator = HeatmapGrid(cfg.heatmap_size, device=device)
        self.heatmap_patch_embed = PatchEmbedding(
            cfg.heatmap_in_channels, D, hp, device=device)
        self.cross_modal_fusion_layers = nn.ModuleList(
            CrossModalFusionBlock(D, cfg.transformer_heads,
                                  cfg.transformer_mlp_ratio, cfg.activation,
                                  dropout=rate, device=device)
            for _ in range(cfg.num_cross_modal_layers)
        )
        self.final_encoder = nn.ModuleList(
            TransformerEncoderBlock(D, cfg.transformer_heads,
                                    cfg.transformer_mlp_ratio,
                                    cfg.activation, timm=False,
                                    dropout=rate, device=device)
            for _ in range(cfg.final_encoder_depth)
        )
        self.norm_out = _ln(D, device)
        self.pose_head = PoseRegressionHead(
            D, cfg.num_joints, cfg.regression_hidden_dims, cfg.activation,
            dropout=cfg.regression_dropout, device=device)

    def forward(self, image, depth, keypoints_2d, *,
                generator: Optional[torch.Generator] = None):
        cfg, dt, impl = self.config, self.dtype, self.attention_impl
        gen = generator if self.training else None
        if (self.training and gen is None
                and (cfg.transformer_dropout_rate or cfg.regression_dropout)):
            raise ValueError(
                "train mode with dropout needs a torch.Generator: pass "
                "forward(..., generator=torch.Generator(device))")
        x = torch.cat([image.to(dt), depth.to(dt)], dim=-1)
        img_tokens = self.vit_backbone(x, dt, impl, gen)[:, 1:]  # strip CLS

        heatmaps = gaussian_heatmaps(keypoints_2d, cfg.heatmap_size,
                                     cfg.heatmap_sigma, dtype=dt)
        hm_tokens = (self.heatmap_patch_embed(heatmaps, dt)
                     + self.pos_embed_hm.to(dt))

        for blk in self.cross_modal_fusion_layers:
            img_tokens, hm_tokens = _block(blk, self.remat, gen, img_tokens,
                                           hm_tokens, dtype=dt, impl=impl)

        B, _, D = img_tokens.shape
        cls = self.final_cls_token.to(dt).expand(B, 1, D)
        tokens = (torch.cat([cls, img_tokens, hm_tokens], dim=1)
                  + self.final_pos_embed.to(dt))
        tokens = dropout(tokens, cfg.transformer_dropout_rate, gen)
        for blk in self.final_encoder:
            tokens = _block(blk, self.remat, gen, tokens, dtype=dt,
                            impl=impl)
        cls_out = layer_norm(tokens[:, 0], self.norm_out, dt)
        return self.pose_head(cls_out, dt, gen)
