"""YOLO11-pose with the upstream topology and state_dict names
(counterpart of ``pose3d_tpu/stage1/yolo11.py``).

The reference runs ultralytics YOLO11x-pose per image for 17 COCO
keypoints. This module is the same graph (ultralytics ``yolo11-pose.yaml``
and ``ultralytics/nn/modules``), NCHW, with the upstream module paths
(``model.23.cv4.0.1.conv.weight``), so a ``yolo11{n,s,m,l,x}-pose.pt``
loads with ``load_state_dict(strict=True)`` once the keys the port does not
hold are dropped: BatchNorm's ``num_batches_tracked`` and the fixed
``arange`` DFL convolution, which :func:`decode_pose` computes
(``stage1/yolo_port.py`` checks and drops them).

  backbone: Conv ×2 → C3k2 (e=0.25) ×2 between strided Convs down to /32,
            SPPF and C2PSA (partial self-attention), layers 0-10;
  neck:     FPN / PAN, layers 11-22 (upsampling and concatenation at
            11, 12, 14, 15, 18 and 21, which hold no parameters);
  head:     layer 23, per level a box branch (DFL over 16 bins × 4 sides),
            a class branch (depthwise-separable) and a keypoint branch.

Inference only: BatchNorm reads its running statistics (eps 1e-3). The
heads' last 1×1 convolutions run in fp32 whatever the model's dtype, as in
the JAX package. ``attention_backend``: ``"xla"`` (the default, as in the
JAX package) is the plain attention, ``"pallas"`` the hand-written Hopper
forward kernel (``ops/kernels/flash_attention.py``) for CUDA tensors and
its plain version for CPU ones; the PSA's key depth is half its value
depth (32 and 64 at the published widths).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.ops.attention import dot_product_attention

# depth multiple, width multiple, max_channels (ultralytics yolo11.yaml)
SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}
# attention_backend → dot_product_attention's impl
ATTENTION_IMPL = {"xla": "reference", "pallas": "auto"}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def attention_impl(backend: str) -> str:
    if backend not in ATTENTION_IMPL:
        raise ValueError(f"attention_backend {backend!r} not in "
                         f"{tuple(ATTENTION_IMPL)}")
    return ATTENTION_IMPL[backend]


class BatchNorm(nn.Module):
    """Inference BatchNorm under ``nn.BatchNorm2d``'s names without
    ``num_batches_tracked``: ``(x − mean)·rsqrt(var + eps)·weight + bias``
    from the running statistics."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Conv(nn.Module):
    """ultralytics Conv: Conv2d (no bias, autopad) → BatchNorm (eps 1e-3)
    → SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c2, 1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """cv1 (k[0]) → cv2 (k[1], groups g), with the residual when
    ``shortcut`` and the widths agree."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1], g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """C3 with kernel-3 bottlenecks (``n`` inner, e=1.0)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    """C2f whose inner modules are C3k(n=2) when ``c3k``, else
    Bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((2 + n) * c, c2)
        self.m = nn.ModuleList(
            C3k(c, c, 2, shortcut) if c3k else Bottleneck(c, c, shortcut)
            for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three stacked 5×5 stride-1
    max-pools."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(4 * c_, c2)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """PSA attention: a 1×1 conv to per-head [q | k | v], softmax(qᵀk /
    √key_dim)·v, and a depthwise 3×3 positional branch on v
    (ultralytics ``block.py`` Attention)."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5,
                 attention_backend: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.impl = attention_impl(attention_backend)
        h = num_heads * (2 * self.key_dim + self.head_dim)
        self.qkv = Conv(dim, h, act=False)
        self.proj = Conv(dim, dim, act=False)
        self.pe = Conv(dim, dim, 3, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        kd, hd = self.key_dim, self.head_dim
        # [B, N, heads, 2·kd + hd]: q, k and v are views of one tensor
        qkv = (self.qkv(x).view(B, self.num_heads, 2 * kd + hd, H * W)
               .permute(0, 3, 1, 2).contiguous())
        q, k, v = qkv.split((kd, kd, hd), dim=3)
        o = dot_product_attention(q, k, v, impl=self.impl).to(v.dtype)
        o = o.permute(0, 2, 3, 1).reshape(B, C, H, W)
        pe = self.pe(v.permute(0, 2, 3, 1).reshape(B, C, H, W))
        return self.proj(o + pe)


class PSABlock(nn.Module):
    def __init__(self, c: int, num_heads: int,
                 attention_backend: str = "xla"):
        super().__init__()
        self.attn = Attention(c, num_heads,
                              attention_backend=attention_backend)
        self.ffn = nn.Sequential(Conv(c, 2 * c), Conv(2 * c, c, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """Partial self-attention over half the channels (layer 10)."""

    def __init__(self, c1: int, n: int = 1, e: float = 0.5,
                 attention_backend: str = "xla"):
        super().__init__()
        self.c = c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv(2 * c, c1)
        self.m = nn.Sequential(*(
            PSABlock(c, c // 64, attention_backend=attention_backend)
            for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


def _fp32_conv(conv: nn.Conv2d, x):
    return conv(x.float())


class PoseHead(nn.Module):
    """Detect + Pose head (layer 23), the v11 depthwise class branch.
    ``forward`` returns the raw per-level ``(box [B, 64, h, w], cls
    [B, nc, h, w], kpt [B, J·D, h, w])``, fp32; :func:`decode_pose`
    decodes them."""

    def __init__(self, ch: Sequence[int], nc: int = 1, reg_max: int = 16,
                 kpt_shape: Tuple[int, int] = (17, 3)):
        super().__init__()
        nk = kpt_shape[0] * kpt_shape[1]
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nk)
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3)),
                nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3)),
                nn.Conv2d(c3, nc, 1)) for x in ch)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          nn.Conv2d(c4, nk, 1)) for x in ch)

    def fp32_modules(self) -> List[nn.Module]:
        return [s[2] for s in (*self.cv2, *self.cv3, *self.cv4)]

    def forward(self, feats):
        out = []
        for i, x in enumerate(feats):
            branch = []
            for cv in (self.cv2[i], self.cv3[i], self.cv4[i]):
                branch.append(_fp32_conv(cv[2], cv[1](cv[0](x))))
            out.append(tuple(branch))
        return out


class YOLO11Pose(nn.Module):
    """The yolo11{scale}-pose graph. ``forward(images [B, 3, S, S])``
    (RGB in [0, 1], S a multiple of 32; upstream letterboxes to 640) →
    per-level raw ``(box, cls, kpt)`` at strides 8, 16, 32 (NCHW, fp32).
    ``dtype`` is the compute dtype of everything but the heads' last
    convolutions: :func:`cast_for_inference` puts the weights in it."""

    def __init__(self, scale: str = "x", nc: int = 1,
                 kpt_shape: Tuple[int, int] = (17, 3),
                 dtype: torch.dtype = torch.float32,
                 attention_backend: str = "xla"):
        super().__init__()
        self.scale, self.nc, self.kpt_shape = scale, nc, tuple(kpt_shape)
        self.dtype = dtype
        self.attention_backend = attention_backend
        d, wmul, mc = SCALES[scale]

        def c(ch):
            return make_divisible(min(ch, mc) * wmul)

        rep = max(round(2 * d), 1)
        # parse_model forces c3k=True for every C3k2 at scales m, l and x
        force = scale in ("m", "l", "x")
        layers: List[nn.Module] = [
            Conv(3, c(64), 3, 2),                                    # 0
            Conv(c(64), c(128), 3, 2),                               # 1
            C3k2(c(128), c(256), rep, force, 0.25),                  # 2
            Conv(c(256), c(256), 3, 2),                              # 3
            C3k2(c(256), c(512), rep, force, 0.25),                  # 4
            Conv(c(512), c(512), 3, 2),                              # 5
            C3k2(c(512), c(512), rep, True),                         # 6
            Conv(c(512), c(1024), 3, 2),                             # 7
            C3k2(c(1024), c(1024), rep, True),                       # 8
            SPPF(c(1024), c(1024)),                                  # 9
            C2PSA(c(1024), rep, attention_backend=attention_backend),  # 10
            nn.Identity(), nn.Identity(),                            # 11, 12
            C3k2(c(1024) + c(512), c(512), rep, force),              # 13
            nn.Identity(), nn.Identity(),                            # 14, 15
            C3k2(c(512) + c(512), c(256), rep, force),               # 16
            Conv(c(256), c(256), 3, 2),                              # 17
            nn.Identity(),                                           # 18
            C3k2(c(256) + c(512), c(512), rep, force),               # 19
            Conv(c(512), c(512), 3, 2),                              # 20
            nn.Identity(),                                           # 21
            C3k2(c(512) + c(1024), c(1024), rep, True),              # 22
            PoseHead((c(256), c(512), c(1024)), nc, 16, kpt_shape),  # 23
        ]
        self.model = nn.ModuleList(layers)

    def fp32_modules(self) -> List[nn.Module]:
        return self.model[23].fp32_modules()

    def forward(self, images):
        m = self.model
        up = lambda t: F.interpolate(t, scale_factor=2.0,  # noqa: E731
                                     mode="nearest")
        x = images.to(self.dtype)
        x = m[3](m[2](m[1](m[0](x))))
        x4 = m[4](x)
        x6 = m[6](m[5](x4))
        x10 = m[10](m[9](m[8](m[7](x6))))
        x13 = m[13](torch.cat([up(x10), x6], 1))
        x16 = m[16](torch.cat([up(x13), x4], 1))                   # P3
        x19 = m[19](torch.cat([m[17](x16), x13], 1))               # P4
        x22 = m[22](torch.cat([m[20](x19), x10], 1))               # P5
        return m[23]((x16, x19, x22))


def set_attention_backend(model: nn.Module, backend: str) -> nn.Module:
    """Every attention of ``model`` (YOLO11's PSA, DepthPro's Dinov2
    layers) to ``backend`` ("xla" or "pallas"), the weights untouched."""
    impl = attention_impl(backend)
    for m in model.modules():
        if hasattr(m, "impl"):
            m.impl = impl
    model.attention_backend = backend
    return model


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Weights in ``dtype``, those of ``model.fp32_modules()`` kept fp32;
    the model in eval mode with no parameter requiring grad."""
    model.to(dtype)
    for m in model.fp32_modules():
        m.float()
    model.dtype = dtype
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Decoding (ultralytics head.py Detect._inference + Pose.kpts_decode)
# ---------------------------------------------------------------------------


def decode_pose(raw, strides=(8, 16, 32), kpt_shape=(17, 3)):
    """Raw per-level heads → ``(boxes_xywh [B, A, 4]`` px, ``scores
    [B, A, nc]``, ``kpts [B, A, J, D]`` with pixel x, y and the sigmoid
    confidence) in the network input frame; A = Σ h·w over the levels,
    row-major within a level.

    Box: DFL, a softmax over 16 bins a side and its expectation, then
    dist2bbox around the (cell + 0.5) anchor, times the stride.
    Keypoints: (2·raw + anchor − 0.5)·stride."""
    nj, nd = kpt_shape
    boxes, scores, kpts = [], [], []
    for (box, cls, kpt), stride in zip(raw, strides):
        B, _, h, w = box.shape
        A = h * w
        dev = box.device
        ax = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5
              ).repeat(h)
        ay = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5
              ).repeat_interleave(w)
        bl = box.float().reshape(B, 4, 16, A).permute(0, 3, 1, 2)
        bins = torch.arange(16, dtype=torch.float32, device=dev)
        dist = (torch.softmax(bl, dim=-1) * bins).sum(-1)      # [B, A, 4]
        anchor = torch.stack([ax, ay], dim=-1)[None]            # [1, A, 2]
        x1y1 = anchor - dist[..., :2]
        x2y2 = anchor + dist[..., 2:]
        boxes.append(torch.cat([(x1y1 + x2y2) / 2 * stride,
                                (x2y2 - x1y1) * stride], dim=-1))
        scores.append(torch.sigmoid(
            cls.float().reshape(B, -1, A).permute(0, 2, 1)))
        k = kpt.float().reshape(B, nj, nd, A).permute(0, 3, 1, 2)
        kx = (k[..., 0] * 2.0 + (ax[None, :, None] - 0.5)) * stride
        ky = (k[..., 1] * 2.0 + (ay[None, :, None] - 0.5)) * stride
        parts = [kx, ky] + ([torch.sigmoid(k[..., 2])] if nd == 3 else [])
        kpts.append(torch.stack(parts, dim=-1))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(kpts, 1)


def best_person_keypoints(raw, input_size: int, strides=(8, 16, 32),
                          kpt_shape=(17, 3)):
    """The best detection of each image → ``([B, J, D]`` keypoints with x, y
    normalised to the input frame, ``[B]`` its confidence); ties go to the
    lower anchor index (``argmax``), as in the JAX package."""
    _, scores, kpts = decode_pose(raw, strides, kpt_shape)
    conf = scores.max(dim=-1).values                          # [B, A]
    best = torch.argmax(conf, dim=1)
    b = torch.arange(conf.shape[0], device=conf.device)
    sel = kpts[b, best]
    return (torch.cat([sel[..., :2] / input_size, sel[..., 2:]], dim=-1),
            conf[b, best])


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: descending, ties to the
    lower index (a stable sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_persons(boxes, scores, kpts, max_det: int = 10,
                conf_threshold: float = 0.25, iou_threshold: float = 0.45):
    """Greedy class-agnostic box NMS over the decoded detections, on a
    fixed budget of K = min(max(4·max_det, 32), A) candidates →
    ``(kpts [B, max_det, J, D], conf [B, max_det])``; suppressed slots have
    conf 0."""
    B, A = scores.shape[:2]
    conf = scores.max(dim=-1).values
    K = min(max(4 * max_det, 32), A)
    top_c, idx = _top_k(conf, K)
    bidx = torch.arange(B, device=conf.device)[:, None]
    bx = boxes[bidx, idx]                                     # [B, K, 4]
    kp = kpts[bidx, idx]
    half = bx[..., 2:] / 2
    mins, maxs = bx[..., :2] - half, bx[..., :2] + half
    area = bx[..., 2] * bx[..., 3]
    keep = torch.ones((B, K), dtype=torch.bool, device=conf.device)
    later = torch.arange(K, device=conf.device)
    for i in range(K):
        lo = torch.maximum(mins[:, i:i + 1], mins)
        hi = torch.minimum(maxs[:, i:i + 1], maxs)
        inter = (hi - lo).clamp_min(0).prod(-1)
        iou = inter / (area[:, i:i + 1] + area - inter + 1e-9)
        keep = keep & ~((iou > iou_threshold) & (later > i)[None]
                        & keep[:, i:i + 1])
    final = torch.where(keep & (top_c >= conf_threshold), top_c,
                        torch.zeros_like(top_c))
    sel_c, sel_i = _top_k(final, max_det)
    return kp[bidx, sel_i], sel_c


def letterbox_params(h: int, w: int, size: int = 640):
    """ultralytics LetterBox: scale r = min(size/h, size/w), centred pad.
    Returns ``(r, new_w, new_h, pad_x, pad_y)`` with the upstream rounding
    (the pad split in halves, round(± 0.1))."""
    r = min(size / h, size / w)
    new_w, new_h = round(w * r), round(h * r)
    dw, dh = (size - new_w) / 2, (size - new_h) / 2
    left, top = round(dw - 0.1), round(dh - 0.1)
    return r, new_w, new_h, left, top
