"""Plain fp32 forward of the transformer lifter (the same repository's
transformer config over ViT-B/16, Dosovitskiy et al., arXiv:2010.11929):
a ViT over RGB + depth (patch 16, CLS, learned positions, pre-LN blocks),
a heatmap stream of patch-embedded Gaussians, bidirectional cross-modal
fusion blocks, a final pre-LN encoder over [CLS | image | heatmap] tokens
and an MLP head on the CLS token.

Attention is the materialised softmax(q·kᵀ/√D)·v; LayerNorm eps 1e-6;
the activations are exact (erf) GELU. Dropout sits where the trained model
has it: after each attention's output projection and each MLP layer of the
fusion and final blocks, on the final encoder's tokens, and after each
hidden layer of the head (the ViT's own rate is 0)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from perfbench.reference.common import (
    Precision,
    activation,
    attention,
    heatmaps,
    layer_norm,
    linear,
)


class ViT:
    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor],
                 prec: Precision,
                 dropout: Callable[[torch.Tensor, float], torch.Tensor]):
        self.cfg, self.sd, self.prec = cfg, sd, prec
        self.dropout = dropout
        self.act = activation(cfg["activation"])

    def patches(self, x, p, prefix):
        """[B, H, W, C] → [B, N, D]: each p×p patch flattened in the
        weight's (C, kh, kw) order, row-major over the patch grid."""
        B, H, W, C = x.shape
        t = (x.view(B, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
             .reshape(B, (H // p) * (W // p), C * p * p))
        w = self.sd[prefix + "weight"]
        return linear(t, w.reshape(w.shape[0], -1), self.sd[prefix + "bias"],
                      self.prec)

    def attend(self, q_in, kv_in, w, b, out_prefix, heads, rate):
        B, Tq, D = q_in.shape
        hd = D // heads
        prec = self.prec
        if kv_in is q_in:
            qkv = linear(q_in, w, b, prec).view(B, Tq, 3, heads, hd)
            q, k, v = qkv.unbind(2)
        else:
            q = linear(q_in, w[:D], b[:D], prec).view(B, Tq, heads, hd)
            kv = linear(kv_in, w[D:], b[D:], prec).view(
                B, kv_in.shape[1], 2, heads, hd)
            k, v = kv.unbind(2)
        o = attention(q, k, v, prec).reshape(B, Tq, D)
        o = linear(o, self.sd[out_prefix + "weight"],
                   self.sd[out_prefix + "bias"], prec)
        return self.dropout(o, rate)

    def mlp(self, x, p1, p2, rate):
        sd = self.sd
        h = self.act(linear(x, sd[p1 + "weight"], sd[p1 + "bias"], self.prec))
        h = self.dropout(h, rate)
        return self.dropout(linear(h, sd[p2 + "weight"], sd[p2 + "bias"],
                                   self.prec), rate)

    def encoder_block(self, x, p, heads, rate, timm):
        sd = self.sd
        y = layer_norm(x, sd, p + "norm1.")
        if timm:
            a = self.attend(y, y, sd[p + "attn.qkv.weight"],
                            sd[p + "attn.qkv.bias"], p + "attn.proj.", heads,
                            rate)
            m1, m2 = p + "mlp.fc1.", p + "mlp.fc2."
        else:
            a = self.attend(y, y, sd[p + "attn.in_proj_weight"],
                            sd[p + "attn.in_proj_bias"], p + "attn.out_proj.",
                            heads, rate)
            m1, m2 = p + "mlp.0.", p + "mlp.3."
        x = x + a
        return x + self.mlp(layer_norm(x, sd, p + "norm2."), m1, m2, rate)

    def fusion_block(self, x_img, x_hm, p, heads, rate):
        sd = self.sd

        def cross(q_in, kv_in, name):
            return self.attend(q_in, kv_in, sd[f"{p}{name}.in_proj_weight"],
                               sd[f"{p}{name}.in_proj_bias"],
                               f"{p}{name}.out_proj.", heads, rate)
        x_img = x_img + cross(layer_norm(x_img, sd, p + "norm_img_q."),
                              layer_norm(x_hm, sd, p + "norm_hm_kv."),
                              "cross_attn_img_to_hm")
        x_hm = x_hm + cross(layer_norm(x_hm, sd, p + "norm_hm_q."),
                            layer_norm(x_img, sd, p + "norm_img_kv."),
                            "cross_attn_hm_to_img")
        x_img = x_img + self.mlp(layer_norm(x_img, sd, p + "norm_img_mlp."),
                                 p + "mlp_img.0.", p + "mlp_img.3.", rate)
        x_hm = x_hm + self.mlp(layer_norm(x_hm, sd, p + "norm_hm_mlp."),
                               p + "mlp_hm.0.", p + "mlp_hm.3.", rate)
        return x_img, x_hm

    def forward(self, image, depth, kpts):
        """image [B, H, W, 3], depth [B, H, W, 1], kpts [B, J, 2] →
        joints [B, J, 3]."""
        cfg, sd = self.cfg, self.sd
        rate = cfg["transformer_dropout_rate"]
        x = torch.cat([image, depth], dim=-1)
        t = self.patches(x, cfg["vit_patch_size"], "vit_backbone.patch_embed.proj.")
        B, _, D = t.shape
        t = torch.cat([sd["vit_backbone.cls_token"].expand(B, 1, D), t], 1) \
            + sd["vit_backbone.pos_embed"]
        for i in range(cfg["vit_depth"]):
            t = self.encoder_block(t, f"vit_backbone.blocks.{i}.",
                                   cfg["vit_heads"], 0.0, timm=True)
        img = layer_norm(t, sd, "vit_backbone.norm.")[:, 1:]
        hm = heatmaps(kpts, cfg["heatmap_size"], cfg["heatmap_sigma"])
        hm = self.patches(hm.permute(0, 2, 3, 1), cfg["heatmap_patch_size"],
                          "heatmap_patch_embed.proj.") + sd["pos_embed_hm"]
        heads = cfg["transformer_heads"]
        for i in range(cfg["num_cross_modal_layers"]):
            img, hm = self.fusion_block(img, hm,
                                        f"cross_modal_fusion_layers.{i}.",
                                        heads, rate)
        t = torch.cat([sd["final_cls_token"].expand(B, 1, D), img, hm], 1) \
            + sd["final_pos_embed"]
        t = self.dropout(t, rate)
        for i in range(cfg["final_encoder_depth"]):
            t = self.encoder_block(t, f"final_encoder.{i}.", heads, rate,
                                   timm=False)
        x = layer_norm(t[:, 0], sd, "norm_out.")
        n = len(cfg["regression_hidden_dims"])
        for k in range(n):
            p = f"pose_head.decoder.{3 * k}."
            x = self.act(linear(x, sd[p + "weight"], sd[p + "bias"], self.prec))
            x = self.dropout(x, cfg["regression_dropout"])
        p = f"pose_head.decoder.{3 * n}."
        x = F.linear(x, sd[p + "weight"], sd[p + "bias"])
        return x.reshape(B, -1, 3)
