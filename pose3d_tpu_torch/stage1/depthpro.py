"""Apple DepthPro with the HF graph and state_dict names (counterpart of
``pose3d_tpu/stage1/depthpro.py``).

The reference runs ``DepthProForDepthEstimation`` (HF transformers) per
image for metric depth. This module is the same architecture, NCHW, with
HF's module paths, so ``apple/DepthPro-hf`` weights load with
``load_state_dict(strict=True)`` once the keys the forward never reads are
dropped (``stage1/depthpro_port.py``):

* three Dinov2 ViT encoders: a *patch* encoder run on 384×384 crops of
  the 1536×1536 input at scales ×1 (25 overlapping patches), ×0.5 (9) and
  ×0.25 (1), all 35 of an image in one batch; an *image* encoder on the
  ×0.25 image; and a *FOV* encoder for the field-of-view head;
* patch-grid reassembly with the overlaps trimmed (:func:`merge_patches`)
  and bilinear resizing (``F.interpolate``, ``align_corners=False``, no
  antialiasing: the JAX package's matrix form copies exactly that) to a
  power-of-two feature pyramid;
* transposed-convolution upsampling blocks (``nn.ConvTranspose2d`` k 2,
  s 2) and a DPT-style pre-activation residual fusion stage;
* a depth head giving the canonical inverse depth, and a FOV head whose
  angle turns it into metric depth (:func:`postprocess_depth`).

Inference only. ``dtype`` is the compute dtype (``cast_for_inference``
puts the weights in it; the depth head's and FOV head's last convolutions
stay fp32, as in the JAX package). ``attention_backend``: ``"xla"`` (the
default, as in the JAX package) runs the plain attention, ``"pallas"`` the
hand-written Hopper forward kernel for CUDA tensors (577 tokens, 16 heads,
depth 64 at the published widths) and its plain version for CPU ones. The
patch embedding is the matmul it is (each 16×16 patch flattened times the
``[D, 3·16·16]`` weight) rather than a convolution call: oneDNN's bf16
convolution gives wrong results for this shape on some CPUs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.stage1.yolo11 import attention_impl


@dataclass(frozen=True)
class ViTArch:
    """Dinov2 encoder hyperparameters (a subset of HF's Dinov2Config)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 16
    image_size: int = 384
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6

    @property
    def out_size(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class DepthProArch:
    """DepthPro hyperparameters (a subset of HF's DepthProConfig; the
    defaults are apple/DepthPro-hf's)."""

    fusion_hidden_size: int = 256
    patch_size: int = 384
    intermediate_hook_ids: Tuple[int, ...] = (11, 5)
    intermediate_feature_dims: Tuple[int, ...] = (256, 256)
    scaled_images_ratios: Tuple[float, ...] = (0.25, 0.5, 1.0)
    scaled_images_overlap_ratios: Tuple[float, ...] = (0.0, 0.5, 0.25)
    scaled_images_feature_dims: Tuple[int, ...] = (1024, 1024, 512)
    merge_padding_value: int = 3
    use_fov_model: bool = True
    num_fov_head_layers: int = 2
    image_size: int = 1536  # the network's input resolution
    vit: ViTArch = field(default_factory=ViTArch)


# ---------------------------------------------------------------------------
# Dinov2 encoder
# ---------------------------------------------------------------------------


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _Dense(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense = nn.Linear(d, d)


class _AttentionBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.attention = _SelfAttention(d)
        self.output = _Dense(d)


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(d))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Dinov2Layer(nn.Module):
    """Pre-LN block: x + λ1·attn(LN(x)), then x + λ2·mlp(LN(x)) with the
    exact GELU; softmax(qkᵀ/√d)·v over ``num_heads`` heads."""

    def __init__(self, arch: ViTArch, attention_backend: str = "xla"):
        super().__init__()
        d = arch.hidden_size
        self.num_heads = arch.num_heads
        self.impl = attention_impl(attention_backend)
        self.norm1 = nn.LayerNorm(d, eps=arch.layer_norm_eps)
        self.attention = _AttentionBlock(d)
        self.layer_scale1 = _LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=arch.layer_norm_eps)
        self.mlp = _Mlp(d, d * arch.mlp_ratio)
        self.layer_scale2 = _LayerScale(d)

    def forward(self, x):
        B, T, D = x.shape
        h = self.norm1(x)
        a = self.attention.attention
        q, k, v = (lin(h).view(B, T, self.num_heads, -1)
                   for lin in (a.query, a.key, a.value))
        o = dot_product_attention(q, k, v, impl=self.impl).to(v.dtype)
        o = self.attention.output.dense(o.reshape(B, T, D))
        x = x + o * self.layer_scale1.lambda1
        m = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + m * self.layer_scale2.lambda1


class _PatchEmbeddings(nn.Module):
    def __init__(self, d: int, patch: int):
        super().__init__()
        self.patch = patch
        self.projection = nn.Conv2d(3, d, patch, stride=patch)

    def forward(self, x):
        """[B, C, S, S] → [B, (S/p)², D], tokens row-major."""
        p = self.patch
        B, C, H, W = x.shape
        patches = (x.reshape(B, C, H // p, p, W // p, p)
                   .permute(0, 2, 4, 1, 3, 5)
                   .reshape(B, (H // p) * (W // p), C * p * p))
        w = self.projection.weight.reshape(self.projection.out_channels, -1)
        return F.linear(patches, w, self.projection.bias)


class _Embeddings(nn.Module):
    def __init__(self, arch: ViTArch):
        super().__init__()
        d = arch.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, arch.out_size ** 2 + 1, d))
        self.patch_embeddings = _PatchEmbeddings(d, arch.patch_size)

    def forward(self, x):
        t = self.patch_embeddings(x)
        cls = self.cls_token.expand(t.shape[0], 1, t.shape[2])
        return torch.cat([cls, t], dim=1) + self.position_embeddings


class _Encoder(nn.Module):
    def __init__(self, arch: ViTArch, attention_backend: str):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Layer(arch, attention_backend)
                                   for _ in range(arch.num_layers))


class Dinov2Model(nn.Module):
    """HF Dinov2Model: patch embedding, class token and positions, the
    layers, a final LayerNorm. Inputs are already at ``arch.image_size``
    (the DepthPro graph makes them so): no position interpolation."""

    def __init__(self, arch: ViTArch, attention_backend: str = "xla"):
        super().__init__()
        self.embeddings = _Embeddings(arch)
        self.encoder = _Encoder(arch, attention_backend)
        self.layernorm = nn.LayerNorm(arch.hidden_size,
                                      eps=arch.layer_norm_eps)

    def forward(self, x, collect_hidden: Sequence[int] = ()):
        """→ (tokens [B, 1 + (S/p)², D], {layer index: its output})."""
        t = self.embeddings(x)
        hidden = {}
        for i, layer in enumerate(self.encoder.layer):
            t = layer(t)
            if i in collect_hidden:
                hidden[i] = t
        return self.layernorm(t), hidden


class _ModelHolder(nn.Module):
    """``<name>.model`` (HF's encoder wrappers)."""

    def __init__(self, arch: ViTArch, attention_backend: str):
        super().__init__()
        self.model = Dinov2Model(arch, attention_backend)


# ---------------------------------------------------------------------------
# Patch split / merge and resizing (HF split_to_patches / merge_patches)
# ---------------------------------------------------------------------------


def split_to_patches(x, patch_size: int, overlap_ratio: float):
    """[B, C, S, S] → ([L·B, C, P, P], L): row-major patch order, the
    patch index major over the batch (HF's unfold and permute order)."""
    B, C, S, _ = x.shape
    if S == patch_size:
        return x, 1
    if S < patch_size:
        raise ValueError(
            f"scaled image size {S} is smaller than patch_size "
            f"{patch_size}: the DepthPro input_size is too small for the "
            "scale pyramid (needs >= 4*patch_size at the full scale)")
    stride = int(patch_size * (1 - overlap_ratio))
    starts = range(0, S - patch_size + 1, stride)
    rows = [x[:, :, sy:sy + patch_size, sx:sx + patch_size]
            for sy in starts for sx in starts]
    return torch.cat(rows, dim=0), len(rows)


def merge_patches(patches, batch_size: int, padding: int):
    """Inverse of the split: [L·B, D, g, g] → [B, D, s·g', s·g'], trimming
    ``padding`` from the interior patch edges (HF merge_patches)."""
    LB, D, g, _ = patches.shape
    L = LB // batch_size
    if L == 1:
        return patches
    s = int(math.isqrt(L))
    if L < 4:
        padding = 0
    padding = min(g // 4, padding)
    grid = patches.reshape(L, batch_size, D, g, g)
    rows = []
    for r in range(s):
        cols = []
        for c in range(s):
            box = grid[r * s + c]
            t = padding if r != 0 else 0
            b = padding if r != s - 1 else 0
            lft = padding if c != 0 else 0
            rgt = padding if c != s - 1 else 0
            cols.append(box[:, :, t:g - b, lft:g - rgt])
        rows.append(torch.cat(cols, dim=3))
    return torch.cat(rows, dim=2)


def resize_bilinear(x, size_hw):
    """torch bilinear resampling (half-pixel centres, no antialiasing) of
    [B, C, H, W] to ``size_hw``; the identity at the same size."""
    oh, ow = int(size_hw[0]), int(size_hw[1])
    if tuple(x.shape[2:]) == (oh, ow):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=False)


def reconstruct_feature_maps(tokens, grid: int, batch_size: int,
                             padding: int, output_size):
    """[N, T, D] ViT tokens → [B, D, out, out]: the class token dropped,
    the grid reshaped, the patches merged, the map resized."""
    N, _, D = tokens.shape
    feat = (tokens[:, -(grid * grid):, :].reshape(N, grid, grid, D)
            .permute(0, 3, 1, 2))
    feat = merge_patches(feat, batch_size=batch_size, padding=padding)
    return resize_bilinear(feat, output_size)


# ---------------------------------------------------------------------------
# Upsample, fusion and heads
# ---------------------------------------------------------------------------


def _deconv2x(c_in: int, c_out: int, bias: bool) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(c_in, c_out, 2, stride=2, bias=bias)


class FeatureUpsampleBlock(nn.Module):
    """[1×1 projection] then ``n_upsample_layers`` transposed
    convolutions, each ×2, under ``layers.<i>``."""

    def __init__(self, in_dims: int, intermediate_dims: int,
                 output_dims: int, n_upsample_layers: int,
                 use_proj: bool = True, bias: bool = False):
        super().__init__()
        layers: List[nn.Module] = []
        c = in_dims
        if use_proj:
            layers.append(nn.Conv2d(c, intermediate_dims, 1, bias=bias))
            c = intermediate_dims
        for _ in range(n_upsample_layers):
            layers.append(_deconv2x(c, output_dims, bias))
            c = output_dims
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PreActResidualLayer(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(features, features, 3, padding=1)
        self.convolution2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y = self.convolution1(F.relu(x))
        return self.convolution2(F.relu(y)) + x


class FeatureFusionLayer(nn.Module):
    """[residual_layer1 on the skip input, added] → residual_layer2 →
    [deconv ×2] → 1×1 projection. The first fusion layer takes no skip
    input, so it holds no residual_layer1 (``with_residual=False``)."""

    def __init__(self, features: int, use_deconv: bool = True,
                 with_residual: bool = True):
        super().__init__()
        if with_residual:
            self.residual_layer1 = PreActResidualLayer(features)
        self.residual_layer2 = PreActResidualLayer(features)
        self.deconv = (_deconv2x(features, features, False) if use_deconv
                       else None)
        self.projection = nn.Conv2d(features, features, 1)

    def forward(self, x, residual=None):
        if residual is not None:
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if self.deconv is not None:
            x = self.deconv(x)
        return self.projection(x)


class _FeatureUpsample(nn.Module):
    def __init__(self, a: DepthProArch):
        super().__init__()
        vit = a.vit
        self.image_block = FeatureUpsampleBlock(
            vit.hidden_size, vit.hidden_size, a.scaled_images_feature_dims[0],
            1, use_proj=False, bias=True)
        self.scaled_images = nn.ModuleList(
            FeatureUpsampleBlock(vit.hidden_size, d, d, 1)
            for d in a.scaled_images_feature_dims)
        self.intermediate = nn.ModuleList(
            FeatureUpsampleBlock(
                vit.hidden_size, a.fusion_hidden_size if i == 0 else d, d,
                2 + i)
            for i, d in enumerate(a.intermediate_feature_dims))

    def forward(self, features):
        n = len(self.scaled_images)
        out = [self.image_block(features[0])]
        out += [blk(f) for blk, f in zip(self.scaled_images,
                                         features[1:n + 1])]
        out += [blk(f) for blk, f in zip(self.intermediate,
                                         features[n + 1:])]
        return out


class _FeatureProjection(nn.Module):
    def __init__(self, a: DepthProArch):
        super().__init__()
        dims = (tuple(a.scaled_images_feature_dims)
                + tuple(a.intermediate_feature_dims))
        f = a.fusion_hidden_size
        self.projections = nn.ModuleList(
            nn.Identity() if i == len(dims) - 1 and d == f
            else nn.Conv2d(d, f, 3, padding=1, bias=False)
            for i, d in enumerate(dims))

    def forward(self, features):
        return [p(x) for p, x in zip(self.projections, features)]


class _Neck(nn.Module):
    def __init__(self, a: DepthProArch):
        super().__init__()
        d0 = a.scaled_images_feature_dims[0]
        self.feature_upsample = _FeatureUpsample(a)
        self.fuse_image_with_low_res = nn.Conv2d(2 * d0, d0, 1)
        self.feature_projection = _FeatureProjection(a)

    def forward(self, features):
        features = self.feature_upsample(features)
        glob = self.fuse_image_with_low_res(
            torch.cat([features[1], features[0]], dim=1))
        return self.feature_projection([glob] + features[2:])


class _DepthProEncoder(nn.Module):
    def __init__(self, a: DepthProArch, attention_backend: str):
        super().__init__()
        self.a = a
        self.patch_encoder = _ModelHolder(a.vit, attention_backend)
        self.image_encoder = _ModelHolder(a.vit, attention_backend)

    def forward(self, x):
        a, vit = self.a, self.a.vit
        B, S = x.shape[0], x.shape[2]
        n_scales = len(a.scaled_images_ratios)
        scaled, counts = [], []
        for i, ratio in enumerate(a.scaled_images_ratios):
            size = int(S * ratio)
            p, L = split_to_patches(resize_bilinear(x, (size, size)),
                                    a.patch_size,
                                    a.scaled_images_overlap_ratios[i])
            scaled.append(p)
            counts.append(L)
        # the high-resolution patches first, through the one encoder
        tokens, hidden = self.patch_encoder.model(
            torch.cat(scaled[::-1], dim=0),
            collect_hidden=tuple(a.intermediate_hook_ids))
        sizes = [c * B for c in counts[::-1]]
        per_scale = list(torch.split(tokens, sizes, dim=0))[::-1]
        base = S // 2 ** int(math.log2(S / vit.out_size))
        feats = []
        for i in range(n_scales):
            pad = int(a.merge_padding_value / a.scaled_images_ratios[i])
            feats.append(reconstruct_feature_maps(
                per_scale[i], vit.out_size, B, pad,
                (base * 2 ** i, base * 2 ** i)))
        pad = int(a.merge_padding_value / a.scaled_images_ratios[-1])
        out = base * 2 ** (n_scales - 1)
        inter = [reconstruct_feature_maps(hidden[h], vit.out_size, B, pad,
                                          (out, out))
                 for h in a.intermediate_hook_ids]
        img = resize_bilinear(x, (vit.image_size, vit.image_size))
        img_tokens, _ = self.image_encoder.model(img)
        imf = reconstruct_feature_maps(img_tokens, vit.out_size, B, 0,
                                       (base, base))
        return [imf] + feats + inter


class _DepthProModel(nn.Module):
    def __init__(self, a: DepthProArch, attention_backend: str):
        super().__init__()
        self.encoder = _DepthProEncoder(a, attention_backend)
        self.neck = _Neck(a)

    def forward(self, x):
        return self.neck(self.encoder(x))


class _FusionStage(nn.Module):
    def __init__(self, a: DepthProArch):
        super().__init__()
        n = len(a.scaled_images_ratios) + len(a.intermediate_feature_dims)
        f = a.fusion_hidden_size
        self.intermediate = nn.ModuleList(
            FeatureFusionLayer(f, True, with_residual=i > 0)
            for i in range(n - 1))
        self.final = FeatureFusionLayer(f, use_deconv=False)

    def forward(self, hs):
        fused = None
        for layer, h in zip(self.intermediate, hs[:-1]):
            fused = layer(h) if fused is None else layer(fused, h)
        return self.final(fused, hs[-1])


class _DepthHead(nn.Module):
    """layers: 0 conv 3×3, 1 deconv ×2, 2 conv 3×3 → 32, 3 ReLU, 4 conv
    1×1 → 1 (fp32), 5 ReLU."""

    def __init__(self, f: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Conv2d(f, f // 2, 3, padding=1),
            _deconv2x(f // 2, f // 2, True),
            nn.Conv2d(f // 2, 32, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
            nn.ReLU(),
        ])

    def forward(self, h):
        h = F.relu(self.layers[2](self.layers[1](self.layers[0](h))))
        return F.relu(self.layers[4](h.float()))[:, 0]


class _FovEncoder(nn.Module):
    def __init__(self, a: DepthProArch, attention_backend: str):
        super().__init__()
        self.a = a
        self.model = Dinov2Model(a.vit, attention_backend)
        self.neck = nn.Linear(a.vit.hidden_size, a.fusion_hidden_size // 2)

    def forward(self, x):
        vit = self.a.vit
        S = x.shape[2]
        tokens, _ = self.model(
            resize_bilinear(x, (vit.image_size, vit.image_size)))
        base = S // 2 ** int(math.log2(S / vit.out_size))
        return reconstruct_feature_maps(self.neck(tokens), vit.out_size,
                                        x.shape[0], 0, (base, base))


class _FovHead(nn.Module):
    """Per layer a stride-2 3×3 conv and a ReLU, then a k×k conv to one
    value (fp32), k = (out − 1)/2^layers + 1."""

    def __init__(self, a: DepthProArch):
        super().__init__()
        self.out_size = a.vit.out_size
        f = a.fusion_hidden_size
        layers: List[nn.Module] = []
        c = f // 2
        for i in range(a.num_fov_head_layers):
            c_out = math.ceil(f / 2 ** (i + 2))
            layers += [nn.Conv2d(c, c_out, 3, stride=2, padding=1),
                       nn.ReLU()]
            c = c_out
        k = int((a.vit.out_size - 1) / 2 ** a.num_fov_head_layers + 1)
        layers.append(nn.Conv2d(c, 1, k))
        self.layers = nn.ModuleList(layers)

    def forward(self, h):
        h = resize_bilinear(h, (self.out_size, self.out_size))
        for layer in self.layers[:-1]:
            h = layer(h)
        return self.layers[-1](h.float()).reshape(h.shape[0])


class _FovModel(nn.Module):
    def __init__(self, a: DepthProArch, attention_backend: str):
        super().__init__()
        self.fov_encoder = _FovEncoder(a, attention_backend)
        self.conv = nn.Conv2d(a.fusion_hidden_size, a.fusion_hidden_size // 2,
                              3, stride=2, padding=1)
        self.head = _FovHead(a)

    def forward(self, x, global_features):
        g = F.relu(self.conv(global_features))
        return self.head(self.fov_encoder(x) + g)


class DepthProDepthEstimator(nn.Module):
    """HF DepthProForDepthEstimation. ``forward(pixel_values [B, 3, S, S])``
    (already (x/255 − 0.5)/0.5, HF's image processor) → ``(canonical
    inverse depth [B, S, S]`` fp32, ``fov_deg [B]`` fp32 or None)."""

    def __init__(self, arch: DepthProArch = DepthProArch(),
                 dtype: torch.dtype = torch.float32,
                 attention_backend: str = "xla"):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.attention_backend = attention_backend
        self.depth_pro = _DepthProModel(arch, attention_backend)
        self.fusion_stage = _FusionStage(arch)
        self.head = _DepthHead(arch.fusion_hidden_size)
        self.fov_model = (_FovModel(arch, attention_backend)
                          if arch.use_fov_model else None)

    def fp32_modules(self) -> List[nn.Module]:
        out = [self.head.layers[4]]
        if self.fov_model is not None:
            out.append(self.fov_model.head.layers[-1])
        return out

    def forward(self, pixel_values):
        x = pixel_values.to(self.dtype)
        features = self.depth_pro(x)
        depth = self.head(self.fusion_stage(features))
        fov = (self.fov_model(x, features[0])
               if self.fov_model is not None else None)
        return depth, fov


def fov_scaled_inverse_depth(canonical_depth, fov_deg):
    """FOV calibration of the canonical inverse depth. HF's
    post_process_depth_estimation computes depth·width/focal with
    focal = 0.5·width/tan(fov/2): the widths cancel, leaving
    canonical·2·tan(fov/2), whatever the resolution."""
    if fov_deg is None:
        return canonical_depth
    scale = 2.0 * torch.tan(0.5 * torch.deg2rad(fov_deg))
    return canonical_depth * scale[:, None, None]


def postprocess_depth(canonical_depth, fov_deg, width: int = 0):
    """HF post_process_depth_estimation: FOV-calibrated metric depth at the
    network's resolution (``width`` cancels, see
    :func:`fov_scaled_inverse_depth`). To resize to the image, resize the
    inverse depth and invert after, as HF orders it
    (``stage1/models.py``'s DepthProBackend)."""
    inv = fov_scaled_inverse_depth(canonical_depth, fov_deg)
    return 1.0 / torch.clamp(inv, 1e-4, 1e4)
