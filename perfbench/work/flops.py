"""Analytic work of the two lifters, from their configurations alone.

Forward FLOPs per sample count every matrix product and convolution (2
per multiply-add), attention's two products included, and nothing
elementwise: what a training or serving step must compute at the least,
whatever implements it. A training step is three forwards' worth (the
forward, and the backward's two products per product), no recompute
counted.

Attention's work per call, at its true head depth: the forward's 4·B·H·Tq·Tk·D
and the backward's 10·B·H·Tq·Tk·D (the scores again, then dV, dP, dQ, dK:
P is not an input of the backward), and its bytes with each input read
once and each output written once, in the compute dtype (2 bytes) with
the fp32 row log-sum-exp beside them."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from perfbench.reference.cnn import stage_blocks

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s


def _conv_out(n: int, k: int, stride: int, dilation: int = 1) -> int:
    pad = (k - 1) // 2 * dilation
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def cnn_forward_flops(cfg: dict) -> float:
    """Matrix-product and convolution FLOPs of one sample's forward."""
    total = 0.0
    size = cfg["image_size"][0]
    k_dw = 3

    def conv(c_in, c_out, k, stride=1, groups=1, dilation=1):
        nonlocal total, size
        size = _conv_out(size, k, stride, dilation)
        total += 2.0 * size * size * c_out * (c_in // groups) * k * k

    def conv_at(n, c_in, c_out, k=1, dilation=1):
        nonlocal total
        total += 2.0 * n * n * c_out * c_in * k * k

    def se(c, reduction=16):
        nonlocal total
        mid = max(1, c // reduction)
        total += 2.0 * (c * mid + mid * c)

    def eca(c):
        nonlocal total
        t = int(abs(math.log2(c) + 1) / 2)
        k = t if t % 2 else t + 1
        total += 2.0 * c * k

    def coord(c):
        nonlocal total
        mid = max(8, c // 32)
        total += 2.0 * (2 * size * c * mid + 2 * size * mid * c)

    def attend(kind, c):
        {"se": se, "eca": eca, "coord": coord}[kind](c)

    c0 = cfg["initial_channels"]
    conv(cfg["in_channels"], c0, cfg["initial_kernel_size"],
         cfg["initial_stride"])
    conv(c0, c0, 3)
    for _p, dual, att, expand, stride, c_in, c_out in stage_blocks(cfg):
        n_in = size
        if dual:
            conv(c_in, c_out, 1)
            conv(c_out, c_out, k_dw, stride, groups=c_out)
            conv(c_out, c_out, 1)
            conv(c_out, c_out, 1)
            n_out = size
            size = n_in
            d = c_out // 2
            conv(c_in, d, 1)
            conv(d, d, k_dw, stride, groups=d)
            conv(d, d, 1)
            if stride != 1 or c_in != c_out:
                conv_at(n_out, c_in, c_out)
            size = n_out
            conv(c_out + d, c_out, 1)
            attend(att, c_out)
        else:
            hidden = int(c_in * expand)
            if expand != 1:
                conv(c_in, hidden, 1)
            conv(hidden, hidden, k_dw, stride, groups=hidden)
            attend(att, hidden)
            conv(hidden, c_out, 1)
    c = cfg["stage_channels"][-1]
    n = size
    conv_at(n, c, c)
    for d in cfg["wasp_dilations"]:
        conv_at(n, c, c, 3, d)
    conv_at(1, c, c)
    conv_at(n, c, c)
    g = cfg["global_pool_size"]
    size = g
    conv_at(g, c, cfg["global_feature_dim"])
    eca(cfg["global_feature_dim"])
    dims = [cfg["global_feature_dim"], *cfg["regression_dims"],
            cfg["num_joints"] * 3]
    total += sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    return total


def vit_attention_calls(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(Tq, Tk, H, D) of every attention call of one forward, per sample."""
    p = cfg["vit_patch_size"]
    n_img = (cfg["image_size"][0] // p) * (cfg["image_size"][1] // p)
    n_hm = (cfg["heatmap_size"] // cfg["heatmap_patch_size"]) ** 2
    D = cfg["transformer_embed_dim"]
    calls = [(n_img + 1, n_img + 1, cfg["vit_heads"], D // cfg["vit_heads"])
             ] * cfg["vit_depth"]
    H = cfg["transformer_heads"]
    for _ in range(cfg["num_cross_modal_layers"]):
        calls += [(n_img, n_hm, H, D // H), (n_hm, n_img, H, D // H)]
    t = 1 + n_img + n_hm
    calls += [(t, t, H, D // H)] * cfg["final_encoder_depth"]
    return calls


def vit_forward_flops(cfg: dict) -> float:
    """Matrix-product FLOPs of one sample's forward."""
    D = cfg["transformer_embed_dim"]
    p = cfg["vit_patch_size"]
    n_img = (cfg["image_size"][0] // p) * (cfg["image_size"][1] // p)
    hp = cfg["heatmap_patch_size"]
    n_hm = (cfg["heatmap_size"] // hp) ** 2
    hidden = int(D * cfg["transformer_mlp_ratio"])
    vit_hidden = 4 * D
    total = 2.0 * n_img * cfg["image_in_channels"] * p * p * D
    total += 2.0 * n_hm * cfg["heatmap_in_channels"] * hp * hp * D
    t = n_img + 1
    total += cfg["vit_depth"] * (2.0 * t * D * 4 * D
                                 + 2.0 * 2 * t * D * vit_hidden)
    for _ in range(cfg["num_cross_modal_layers"]):
        for tq, tk in ((n_img, n_hm), (n_hm, n_img)):
            total += 2.0 * tq * D * D * 2 + 2.0 * tk * D * 2 * D
        total += 2.0 * 2 * (n_img + n_hm) * D * hidden
    t = 1 + n_img + n_hm
    total += cfg["final_encoder_depth"] * (2.0 * t * D * 4 * D
                                           + 2.0 * 2 * t * D * hidden)
    for tq, tk, h, d in vit_attention_calls(cfg):
        total += 4.0 * tq * tk * h * d
    dims = [D, *cfg["regression_hidden_dims"], cfg["num_joints"] * 3]
    total += sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    return total


def forward_flops(cfg: dict) -> float:
    return (cnn_forward_flops(cfg) if cfg["model_type"] == "cnn"
            else vit_forward_flops(cfg))


def attention_work(tq: int, tk: int, h: int, d: int, batch: int,
                   backward: bool) -> Dict[str, float]:
    """FLOPs and bytes of one attention call over ``batch`` samples."""
    bh = batch * h
    if not backward:
        flops = 4.0 * bh * tq * tk * d
        bytes_ = 2.0 * bh * d * (2 * tq + 2 * tk) + 4.0 * bh * tq
    else:
        flops = 10.0 * bh * tq * tk * d
        # read q, k, v, o, dO and lse; write dq, dk, dv
        bytes_ = (2.0 * bh * d * (3 * tq + 2 * tk) + 4.0 * bh * tq
                  + 2.0 * bh * d * (tq + 2 * tk))
    return {"flops": flops, "bytes": bytes_}


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_HBM_BYTES)


def attention_least_seconds(cfg: dict, samples: int, backward: bool) -> float:
    """Least time of one pass's attention calls over ``samples`` samples
    (forward only, or forward and backward)."""
    total = 0.0
    for tq, tk, h, d in vit_attention_calls(cfg):
        w = attention_work(tq, tk, h, d, samples, False)
        total += least_seconds(w["flops"], w["bytes"])
        if backward:
            w = attention_work(tq, tk, h, d, samples, True)
            total += least_seconds(w["flops"], w["bytes"])
    return total
