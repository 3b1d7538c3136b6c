"""Plain fp32 forward of the CNN lifter (AliEmreSenel/3DHumanPoseEstimation,
``src/model_config.py``'s CNN): RGB + depth + 17 Gaussian heatmaps at full
resolution, a strided stem, three stages of inverted-residual and
dual-path blocks with SE, ECA and coordinate attention, a weighted atrous
spatial pyramid, 8×8 pooling to 1,024 features and an MLP head.

NCHW, ``F.conv2d`` and plain BatchNorm arithmetic, reading a flat dict of
weights under the reference checkpoint's names. In train mode each
BatchNorm normalises with the statistics of the batch it is given (one
microbatch) and records them under its prefix for the running averages."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.common import Precision, activation, heatmaps

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def stage_blocks(cfg: dict) -> List[tuple]:
    """One (prefix, is_dual, attention, expand, stride, c_in, c_out) per
    backbone block, in call order: the published stage schedule (a stage's
    first block takes its stride; in the last stage the first and every
    even-numbered block is dual-path with coordinate attention, the others
    inverted residuals alternating SE and ECA)."""
    out = []
    c_in = cfg["initial_channels"]
    for i, c_out in enumerate(cfg["stage_channels"]):
        lead = "coord" if i >= 2 else "se"
        for j in range(cfg["stage_depths"][i]):
            dual = i >= 2 and cfg["use_dual_path_blocks"] and j % 2 == 0
            att = lead if (j == 0 or dual) else ("eca" if j % 2 == 0
                                                 else "se")
            stride = cfg["stage_strides"][i] if j == 0 else 1
            out.append((f"stages.{i}.{j}.", dual, att,
                        cfg["stage_expand_ratios"][i], stride,
                        c_in if j == 0 else c_out, c_out))
        c_in = c_out
    return out


class Norms:
    """BatchNorm over the channel axis of NCHW (or of [N, L, C] rows)."""

    def __init__(self, sd: Dict[str, torch.Tensor], train: bool):
        self.sd, self.train = sd, train
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        sd = self.sd
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.train:
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            self.stats[prefix] = (mean.detach(), var.detach())
        else:
            mean, var = sd[prefix + "running_mean"], sd[prefix + "running_var"]
        inv = torch.rsqrt(var + BN_EPS) * sd[prefix + "weight"]
        return (x - mean.view(shape)) * inv.view(shape) \
            + sd[prefix + "bias"].view(shape)


class CNN:
    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor],
                 prec: Precision, train: bool,
                 dropout: Callable[[torch.Tensor, float], torch.Tensor]):
        self.cfg, self.sd, self.prec = cfg, sd, prec
        self.norm = Norms(sd, train)
        self.act = activation(cfg["activation"])
        self.dropout = dropout

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        return F.conv2d(self.prec(x), self.prec(w), b, stride, padding,
                        dilation, groups)

    def cba(self, x, p, stride=1, dilation=1, act=True):
        """Conv (no bias, padding (k − 1)/2·dilation) → BatchNorm → act."""
        w = self.sd[p + "conv.weight"]
        k = w.shape[-1]
        groups = x.shape[1] // w.shape[1]
        y = self.conv(x, w, None, stride, (k - 1) // 2 * dilation, dilation,
                      groups)
        y = self.norm(y, p + "norm.")
        return self.act(y) if act else y

    def se(self, x, p):
        y = x.mean((2, 3))
        y = self.act(F.linear(self.prec(y), self.prec(self.sd[p + "fc.0.weight"])))
        y = torch.sigmoid(F.linear(self.prec(y),
                                   self.prec(self.sd[p + "fc.2.weight"])))
        return x * y[:, :, None, None]

    def eca(self, x, p):
        w = self.sd[p + "conv.weight"]
        y = x.mean((2, 3))[:, None, :]
        y = F.conv1d(self.prec(y), self.prec(w), padding=(w.shape[-1] - 1) // 2)
        return x * torch.sigmoid(y[:, 0])[:, :, None, None]

    def coord(self, x, p):
        sd = self.sd
        H = x.shape[2]
        # [B, C, H + W]: the mean over W for each row, then over H per column
        y = torch.cat([x.mean(3), x.mean(2)], dim=2).transpose(1, 2)
        y = F.linear(self.prec(y), self.prec(sd[p + "conv1.weight"].flatten(1)),
                     sd[p + "conv1.bias"])
        y = F.silu(self.norm(y.transpose(1, 2), p + "bn1.")).transpose(1, 2)
        a_h = torch.sigmoid(F.linear(self.prec(y[:, :H]), self.prec(
            sd[p + "conv_h.weight"].flatten(1)), sd[p + "conv_h.bias"]))
        a_w = torch.sigmoid(F.linear(self.prec(y[:, H:]), self.prec(
            sd[p + "conv_w.weight"].flatten(1)), sd[p + "conv_w.bias"]))
        return x * a_h.transpose(1, 2)[:, :, :, None] \
            * a_w.transpose(1, 2)[:, :, None, :]

    def attend(self, x, p, kind):
        return {"se": self.se, "eca": self.eca, "coord": self.coord}[kind](x, p)

    def inverted_residual(self, x, p, att, expand, stride, c_in, c_out):
        i = 0
        y = x
        if expand != 1:
            y = self.cba(y, f"{p}conv.{i}.")
            i += 1
        y = self.cba(y, f"{p}conv.{i}.", stride)
        y = self.attend(y, f"{p}conv.{i + 1}.", att)
        y = self.cba(y, f"{p}conv.{i + 2}.", act=False)
        scale = self.cfg["residual_scale"]
        return x + y * scale if (c_in == c_out and stride == 1) else y

    def dual_path(self, x, p, att, stride, c_in, c_out):
        res = self.cba(x, p + "residual_path.0.")
        res = self.cba(res, p + "residual_path.1.depthwise.", stride)
        res = self.cba(res, p + "residual_path.1.pointwise.")
        res = self.cba(res, p + "residual_path.2.", act=False)
        dense = self.cba(x, p + "dense_path.0.")
        dense = self.cba(dense, p + "dense_path.1.depthwise.", stride)
        dense = self.cba(dense, p + "dense_path.1.pointwise.")
        sc = (self.cba(x, p + "shortcut.", stride, act=False)
              if (stride != 1 or c_in != c_out) else x)
        res = res + sc * self.cfg["residual_scale"]
        out = self.cba(torch.cat([res, dense], dim=1), p + "fusion.")
        return self.attend(out, p + "attention.", att)

    def wasp(self, x, p="wasp."):
        w = torch.softmax(self.sd[p + "weights"], dim=0)
        out = self.cba(x, p + "conv1x1.") * w[0]
        i = 0
        while f"{p}atrous_branches.{i}.conv.weight" in self.sd:
            d = self.cfg["wasp_dilations"][i]
            out = out + self.cba(x, f"{p}atrous_branches.{i}.",
                                 dilation=d) * w[i + 1]
            i += 1
        g = x.mean((2, 3), keepdim=True)
        out = out + self.cba(g, p + "global_branch.1.") * w[-1]
        return self.cba(out, p + "fusion.")

    def forward(self, image, depth, kpts):
        """image [B, H, W, 3], depth [B, H, W, 1], kpts [B, J, 2] →
        joints [B, J, 3]."""
        cfg, sd = self.cfg, self.sd
        hm = heatmaps(kpts, cfg["heatmap_size"], cfg["heatmap_sigma"])
        x = torch.cat([image.permute(0, 3, 1, 2), depth.permute(0, 3, 1, 2),
                       hm], dim=1)
        x = self.cba(x, "conv1.0.", cfg["initial_stride"])
        x = self.cba(x, "conv1.1.")
        for p, dual, att, expand, stride, c_in, c_out in stage_blocks(cfg):
            if dual:
                x = self.dual_path(x, p, att, stride, c_in, c_out)
            else:
                x = self.inverted_residual(x, p, att, expand, stride, c_in,
                                           c_out)
        x = self.wasp(x)
        x = F.adaptive_avg_pool2d(x, cfg["global_pool_size"])
        x = self.cba(x, "global_features.1.")
        x = self.eca(x, "global_features.2.")
        x = x.mean((2, 3))
        n = len(cfg["regression_dims"])
        for k in range(n):
            x = linear_act(x, sd, f"pose_head.decoder.{k}.0.", self.prec,
                           self.act)
            x = self.dropout(x, cfg["regression_dropout"])
        x = F.linear(x, sd[f"pose_head.decoder.{n}.weight"],
                     sd[f"pose_head.decoder.{n}.bias"])
        return x.reshape(x.shape[0], -1, 3)


def linear_act(x, sd, p, prec, act):
    return act(F.linear(prec(x), prec(sd[p + "weight"]), sd[p + "bias"]))


def momentum_update(running: Dict[str, torch.Tensor],
                    stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
    """running ← 0.9·running + 0.1·batch, for each BatchNorm's mean and
    (biased) variance."""
    m = BN_MOMENTUM
    for p, (mean, var) in stats.items():
        running[p + "running_mean"].mul_(m).add_(mean, alpha=1 - m)
        running[p + "running_var"].mul_(m).add_(var, alpha=1 - m)
