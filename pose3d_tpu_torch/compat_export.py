"""Map the JAX package's variable trees onto the reference project's torch
``state_dict`` names (the port's own numpy-only counterpart of
``pose3d_tpu/compat_export.py``), and the export of a port training
checkpoint as a reference ``.pth`` (:func:`export_torch_checkpoint`).

The state_dict is emitted in the reference modules' exact torch
registration order, including the buffers a strict ``load_state_dict``
requires (BatchNorm ``num_batches_tracked``, the heatmap generator's
meshgrid buffers):

* ``state_dict`` lists each module's own parameters, then its buffers, then
  its children in registration order, e.g. WASP's learned branch weights
  precede its child convolutions.
* ``model.parameters()`` walks the same order, skipping buffers.

Inputs are nested dicts with numpy leaves (``{"params": ...,
"batch_stats": ...}``), keyed as flax names the submodules.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np


class _Writer:
    """Ordered state_dict maker that also records parameter keys (in
    ``model.parameters()`` order) separately from buffers."""

    def __init__(self):
        self.sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.param_keys: List[str] = []

    def p(self, key: str, arr) -> None:  # trainable parameter
        self.sd[key] = np.ascontiguousarray(np.asarray(arr))
        self.param_keys.append(key)

    def b(self, key: str, arr) -> None:  # buffer
        self.sd[key] = np.ascontiguousarray(np.asarray(arr))


def _conv_k(kernel) -> np.ndarray:  # flax [kh, kw, I/g, O] → torch [O, I/g, kh, kw]
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))


def _sub(s: Dict, name: str) -> Dict:
    """The statistics subtree of submodule ``name``: empty where it holds
    no BatchNorm (``batch_stats`` has no entry for it then)."""
    return s.get(name, {})


def _x_cba(w: _Writer, p: Dict, s: Dict, prefix: str) -> None:
    """ConvBnAct params/stats → reference ConvBnAct keys (conv → norm →
    act registration order). flax names the norm ``BatchNorm_0`` under
    normalization="batch" and ``DotStatsBatchNorm_0`` under "batch_dot"
    and "batch_pallas[:N]" (scale, bias and running statistics), a
    ``GroupNorm_0`` under "instance" and "layer" and ``_G_0/GroupNorm_0``
    under "group" (scale and bias: ``torch.nn.GroupNorm``'s weight and
    bias), and nothing under "identity"."""
    conv = p["Conv_0"]
    w.p(prefix + "conv.weight", _conv_k(conv["kernel"]))
    if "bias" in conv:
        w.p(prefix + "conv.bias", conv["bias"])
    gn = p.get("GroupNorm_0") or p.get("_G_0", {}).get("GroupNorm_0")
    if gn is not None:
        w.p(prefix + "norm.weight", gn["scale"])
        w.p(prefix + "norm.bias", gn["bias"])
        return
    name = next((n for n in ("BatchNorm_0", "DotStatsBatchNorm_0")
                 if n in p), None)
    if name is None:            # identity
        return
    bn = p[name]
    st = s[name]
    w.p(prefix + "norm.weight", bn["scale"])
    w.p(prefix + "norm.bias", bn["bias"])
    w.b(prefix + "norm.running_mean", st["mean"])
    w.b(prefix + "norm.running_var", st["var"])
    w.b(prefix + "norm.num_batches_tracked", np.asarray(0, np.int64))


def _x_dwsep(w, p, s, prefix):
    _x_cba(w, p["ConvBnAct_0"], _sub(s, "ConvBnAct_0"), prefix + "depthwise.")
    _x_cba(w, p["ConvBnAct_1"], _sub(s, "ConvBnAct_1"), prefix + "pointwise.")


def _x_se(w, p, prefix):
    # reference SEBlock fc = Sequential[Linear, act, Linear, Sigmoid];
    # the Linears are bias-free
    w.p(prefix + "fc.0.weight", np.asarray(p["Dense_0"]["kernel"]).T)
    w.p(prefix + "fc.2.weight", np.asarray(p["Dense_1"]["kernel"]).T)


def _x_eca(w, p, prefix):
    # flax Conv1d kernel [k, 1, 1] → torch [1, 1, k]
    w.p(prefix + "conv.weight",
        np.transpose(np.asarray(p["Conv_0"]["kernel"]), (2, 1, 0)))


def _x_coord(w, p, s, prefix):
    """Registration order conv1, bn1, conv_h, conv_w."""
    def c1d(kernel):  # flax [1, I, O] → torch [O, I, 1, 1]
        return np.transpose(np.asarray(kernel), (2, 1, 0))[..., None]

    w.p(prefix + "conv1.weight", c1d(p["Conv_0"]["kernel"]))
    w.p(prefix + "conv1.bias", p["Conv_0"]["bias"])
    bn = p["BatchNorm_0"]
    st = s["BatchNorm_0"]
    w.p(prefix + "bn1.weight", bn["scale"])
    w.p(prefix + "bn1.bias", bn["bias"])
    w.b(prefix + "bn1.running_mean", st["mean"])
    w.b(prefix + "bn1.running_var", st["var"])
    w.b(prefix + "bn1.num_batches_tracked", np.asarray(0, np.int64))
    w.p(prefix + "conv_h.weight", c1d(p["Conv_1"]["kernel"]))
    w.p(prefix + "conv_h.bias", p["Conv_1"]["bias"])
    w.p(prefix + "conv_w.weight", c1d(p["Conv_2"]["kernel"]))
    w.p(prefix + "conv_w.bias", p["Conv_2"]["bias"])


def _x_attention(w, p, s, prefix, att_type):
    if att_type == "se":
        _x_se(w, p["SEBlock_0"], prefix)
    elif att_type == "eca":
        _x_eca(w, p["ECABlock_0"], prefix)
    elif att_type == "coord":
        _x_coord(w, p["CoordAttention_0"], _sub(s, "CoordAttention_0"), prefix)


def _x_inverted_residual(w, p, s, prefix, expand_ratio: int, att_type: str):
    """Sequential indices of the reference block: [expand?],
    depthwise, attention, projection."""
    idx = 0
    cba_i = 0
    if expand_ratio != 1:
        _x_cba(w, p[f"ConvBnAct_{cba_i}"], _sub(s, f"ConvBnAct_{cba_i}"),
               f"{prefix}conv.{idx}.")
        idx += 1
        cba_i += 1
    _x_cba(w, p[f"ConvBnAct_{cba_i}"], _sub(s, f"ConvBnAct_{cba_i}"),
           f"{prefix}conv.{idx}.")
    idx += 1
    cba_i += 1
    _x_attention(w, p, s, f"{prefix}conv.{idx}.", att_type)
    idx += 1
    _x_cba(w, p[f"ConvBnAct_{cba_i}"], _sub(s, f"ConvBnAct_{cba_i}"),
           f"{prefix}conv.{idx}.")


def _x_dual_path(w, p, s, prefix, has_shortcut: bool, att_type):
    """Registration order residual_path, dense_path, attention, fusion,
    shortcut — note attention registers BEFORE
    fusion/shortcut even though it is applied last in forward."""
    _x_cba(w, p["ConvBnAct_0"], _sub(s, "ConvBnAct_0"),
           prefix + "residual_path.0.")
    _x_dwsep(w, p["DepthwiseSeparableConv_0"],
             _sub(s, "DepthwiseSeparableConv_0"),
             prefix + "residual_path.1.")
    _x_cba(w, p["ConvBnAct_1"], _sub(s, "ConvBnAct_1"),
           prefix + "residual_path.2.")
    _x_cba(w, p["ConvBnAct_2"], _sub(s, "ConvBnAct_2"),
           prefix + "dense_path.0.")
    _x_dwsep(w, p["DepthwiseSeparableConv_1"],
             _sub(s, "DepthwiseSeparableConv_1"),
             prefix + "dense_path.1.")
    if att_type:
        _x_attention(w, p, s, prefix + "attention.", att_type)
    nxt = 3
    fusion_idx = nxt + (1 if has_shortcut else 0)
    _x_cba(w, p[f"ConvBnAct_{fusion_idx}"], _sub(s, f"ConvBnAct_{fusion_idx}"),
           prefix + "fusion.")
    if has_shortcut:
        _x_cba(w, p[f"ConvBnAct_{nxt}"], _sub(s, f"ConvBnAct_{nxt}"),
               prefix + "shortcut.")


def _x_wasp(w, p, s, prefix):
    """Own ``weights`` parameter first (state_dict lists a module's own
    parameters before its children), then conv1x1, atrous branches, global
    branch, fusion."""
    w.p(prefix + "weights", p["branch_weights"])
    _x_cba(w, p["ConvBnAct_0"], _sub(s, "ConvBnAct_0"), prefix + "conv1x1.")
    for i in range(4):
        _x_cba(w, p[f"ConvBnAct_{i + 1}"], _sub(s, f"ConvBnAct_{i + 1}"),
               f"{prefix}atrous_branches.{i}.")
    _x_cba(w, p["ConvBnAct_5"], _sub(s, "ConvBnAct_5"),
           prefix + "global_branch.1.")
    _x_cba(w, p["ConvBnAct_6"], _sub(s, "ConvBnAct_6"), prefix + "fusion.")


def _x_pose_head(w, p, prefix, n_hidden: int):
    """The reference head: hidden layers are Sequential[Linear, act,
    Dropout] at decoder.{k}.0, final Linear at decoder.{n_hidden}."""
    for k in range(n_hidden):
        d = p[f"Dense_{k}"]
        w.p(f"{prefix}decoder.{k}.0.weight", np.asarray(d["kernel"]).T)
        w.p(f"{prefix}decoder.{k}.0.bias", d["bias"])
    d = p[f"Dense_{n_hidden}"]
    w.p(f"{prefix}decoder.{n_hidden}.weight", np.asarray(d["kernel"]).T)
    w.p(f"{prefix}decoder.{n_hidden}.bias", d["bias"])


def _heatmap_grids(heatmap_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference generator's persistent meshgrid buffers:
    x_grid[i, j] = j, y_grid[i, j] = i."""
    coords = np.arange(heatmap_size, dtype=np.float32)
    y_grid, x_grid = np.meshgrid(coords, coords, indexing="ij")
    return x_grid, y_grid


NORMALIZATIONS = ("batch", "batch_dot", "batch_pallas", "identity",
                  "instance", "layer", "group")


def export_reference_cnn(variables: Dict, cfg) -> _Writer:
    """Map the JAX CNN's variables ({params, batch_stats}) onto a reference
    ``CNNPoseEstimation.state_dict()`` — a :class:`_Writer` whose ``sd`` is
    the ordered state_dict (numpy values, exact torch key order) and whose
    ``param_keys`` is the ``model.parameters()`` order. Every
    ``normalization`` the port builds is taken: "batch", "batch_dot",
    "batch_pallas", "batch_pallas:N", "identity", "instance", "layer" and
    "group".
    """
    norm = getattr(cfg, "normalization", "batch")
    if norm not in NORMALIZATIONS and not norm.startswith("batch_pallas:"):
        raise ValueError(
            f"torch export supports normalization {NORMALIZATIONS} and "
            f"'batch_pallas:N'; got {norm!r}"
        )
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    w = _Writer()

    _x_cba(w, params["ConvBnAct_0"], _sub(stats, "ConvBnAct_0"), "conv1.0.")
    _x_cba(w, params["ConvBnAct_1"], _sub(stats, "ConvBnAct_1"), "conv1.1.")

    x_grid, y_grid = _heatmap_grids(cfg.heatmap_size)
    w.b("heatmap_generator.x_grid", x_grid)
    w.b("heatmap_generator.y_grid", y_grid)

    for prefix, name, is_dual, att, expand, has_shortcut, _, _ \
            in iter_cnn_stage_blocks(cfg):
        if is_dual:
            _x_dual_path(w, params[name], _sub(stats, name), prefix,
                         has_shortcut=has_shortcut, att_type=att)
        else:
            _x_inverted_residual(w, params[name], _sub(stats, name), prefix,
                                 expand, att)

    _x_wasp(w, params["WASPModule_0"], _sub(stats, "WASPModule_0"), "wasp.")

    # global features: Sequential[pool, ConvBnAct, ECA, pool]
    _x_cba(w, params["ConvBnAct_2"], _sub(stats, "ConvBnAct_2"),
           "global_features.1.")
    _x_eca(w, params["ECABlock_0"], "global_features.2.")

    _x_pose_head(w, params["PoseRegressionHead_0"], "pose_head.",
                 len(cfg.regression_dims))
    return w


def iter_cnn_stage_blocks(cfg):
    """Replay the CNN's stage-assembly schedule: yields one
    ``(torch_prefix, flax_name, is_dual, att_type, expand, has_shortcut,
    stride, block_in)`` per backbone block, in call order.

    This is the single source of truth for the exporter below and for the
    port's ``CNNPoseEstimation``. ``has_shortcut`` replays the
    DualPathBlock rule ``stride != 1 or in_channels != out_channels`` with
    the true channel flow: a stage entry with stride 1 and an unchanged
    channel count has no shortcut conv.
    """
    irb = 0
    dpb = 0
    in_channels = cfg.initial_channels
    for i in range(len(cfg.stage_channels)):
        out_channels = cfg.stage_channels[i]
        expand = cfg.stage_expand_ratios[i]
        lead_att = "coord" if i >= 2 else "se"
        for j in range(cfg.stage_depths[i]):
            if j == 0:
                is_dual = i >= 2 and cfg.use_dual_path_blocks
                att = lead_att
                stride = cfg.stage_strides[i]
                block_in = in_channels
            else:
                is_dual = (
                    i >= 2 and cfg.use_dual_path_blocks and j % 2 == 0
                )
                att = lead_att if is_dual else (
                    "eca" if j % 2 == 0 else "se"
                )
                stride = 1
                block_in = out_channels
            if is_dual:
                flax_name = f"DualPathBlock_{dpb}"
                dpb += 1
            else:
                flax_name = f"InvertedResidual_{irb}"
                irb += 1
            yield (
                f"stages.{i}.{j}.", flax_name, is_dual, att, expand,
                stride != 1 or block_in != out_channels, stride, block_in,
            )
        in_channels = out_channels


# -- transformer ----------------------------------------------------------

def _x_ln(w, p, prefix):
    w.p(prefix + "weight", p["scale"])
    w.p(prefix + "bias", p["bias"])


def _x_torch_mha(w, p, prefix):
    """The JAX MultiHeadAttention {query,key,value,out} DenseGeneral trees →
    torch nn.MultiheadAttention (packed in_proj; registration order
    in_proj_weight, in_proj_bias, out_proj)."""
    out_k = np.asarray(p["out"]["kernel"])  # [H, hd, D]
    D = out_k.shape[-1]

    def lin(tree):  # DenseGeneral [D, H, hd] → torch [D(out), D(in)]
        return np.asarray(tree["kernel"]).reshape(D, D).T, \
            np.asarray(tree["bias"]).reshape(D)

    qw, qb = lin(p["query"])
    kw, kb = lin(p["key"])
    vw, vb = lin(p["value"])
    w.p(prefix + "in_proj_weight", np.concatenate([qw, kw, vw], axis=0))
    w.p(prefix + "in_proj_bias", np.concatenate([qb, kb, vb], axis=0))
    w.p(prefix + "out_proj.weight", out_k.reshape(D, D).T)
    w.p(prefix + "out_proj.bias", p["out"]["bias"])


def _x_lin(w, p, prefix):
    w.p(prefix + "weight", np.asarray(p["kernel"]).T)
    w.p(prefix + "bias", p["bias"])


def _x_encoder_block(w, p, prefix):
    """reference TransformerEncoderBlock registration order: norm1, attn,
    norm2, mlp[0]/mlp[3]."""
    _x_ln(w, p["LayerNorm_0"], prefix + "norm1.")
    _x_torch_mha(w, p["MultiHeadAttention_0"], prefix + "attn.")
    _x_ln(w, p["LayerNorm_1"], prefix + "norm2.")
    _x_lin(w, p["Mlp_0"]["Dense_0"], prefix + "mlp.0.")
    _x_lin(w, p["Mlp_0"]["Dense_1"], prefix + "mlp.3.")


def _x_fusion_block(w, p, prefix):
    """reference CrossModalFusionBlock registration order."""
    _x_ln(w, p["LayerNorm_0"], prefix + "norm_img_q.")
    _x_ln(w, p["LayerNorm_1"], prefix + "norm_hm_kv.")
    _x_torch_mha(w, p["img_to_hm"], prefix + "cross_attn_img_to_hm.")
    _x_ln(w, p["LayerNorm_2"], prefix + "norm_hm_q.")
    _x_ln(w, p["LayerNorm_3"], prefix + "norm_img_kv.")
    _x_torch_mha(w, p["hm_to_img"], prefix + "cross_attn_hm_to_img.")
    _x_ln(w, p["LayerNorm_4"], prefix + "norm_img_mlp.")
    _x_lin(w, p["mlp_img"]["Dense_0"], prefix + "mlp_img.0.")
    _x_lin(w, p["mlp_img"]["Dense_1"], prefix + "mlp_img.3.")
    _x_ln(w, p["LayerNorm_5"], prefix + "norm_hm_mlp.")
    _x_lin(w, p["mlp_hm"]["Dense_0"], prefix + "mlp_hm.0.")
    _x_lin(w, p["mlp_hm"]["Dense_1"], prefix + "mlp_hm.3.")


def _x_vit_backbone(w, p, prefix, depth: int):
    """The JAX ViTBackbone → timm VisionTransformer keys. timm's own
    parameters (cls_token, pos_embed) precede its children (patch_embed, blocks, norm) in
    state_dict/parameters() order regardless of __init__ assignment order.

    A stacked-layout backbone (pipeline-parallel training,
    ``vit_stacked=True``) is converted to the looped porting layout first.
    """
    if "blocks" in p:
        from pose3d_tpu_torch.parallel.pp import unstack_vit_blocks

        p = unstack_vit_blocks(p)
    w.p(prefix + "cls_token", p["cls_token"])
    w.p(prefix + "pos_embed", p["pos_embed"])
    w.p(prefix + "patch_embed.proj.weight",
        _conv_k(p["patch_embed"]["Conv_0"]["kernel"]))
    w.p(prefix + "patch_embed.proj.bias", p["patch_embed"]["Conv_0"]["bias"])
    for i in range(depth):
        blk = p[f"block_{i}"]
        b = f"{prefix}blocks.{i}."
        _x_ln(w, blk["LayerNorm_0"], b + "norm1.")
        attn = blk["MultiHeadAttention_0"]
        out_k = np.asarray(attn["out"]["kernel"])  # [H, hd, D]
        D = out_k.shape[-1]

        def lin(tree):
            return np.asarray(tree["kernel"]).reshape(D, D).T, \
                np.asarray(tree["bias"]).reshape(D)

        qw, qb = lin(attn["query"])
        kw, kb = lin(attn["key"])
        vw, vb = lin(attn["value"])
        w.p(b + "attn.qkv.weight", np.concatenate([qw, kw, vw], axis=0))
        w.p(b + "attn.qkv.bias", np.concatenate([qb, kb, vb], axis=0))
        w.p(b + "attn.proj.weight", out_k.reshape(D, D).T)
        w.p(b + "attn.proj.bias", attn["out"]["bias"])
        _x_ln(w, blk["LayerNorm_1"], b + "norm2.")
        _x_lin(w, blk["Mlp_0"]["Dense_0"], b + "mlp.fc1.")
        _x_lin(w, blk["Mlp_0"]["Dense_1"], b + "mlp.fc2.")
    _x_ln(w, p["norm"], prefix + "norm.")


def export_reference_transformer(variables: Dict, cfg) -> _Writer:
    """Map the JAX TransformerPoseEstimation variables onto a reference
    ``TransformerPoseEstimation.state_dict()`` (exact torch key order).

    The module's own parameters (pos_embed_hm, final_cls_token,
    final_pos_embed) lead, then children in
    registration order: vit_backbone, heatmap_generator (buffers only),
    heatmap_patch_embed, cross_modal_fusion_layers, final_encoder,
    norm_out, pose_head. The flat head's Linears sit at decoder indices
    0, 3, 6, ...
    """
    params = variables["params"]
    w = _Writer()
    w.p("pos_embed_hm", params["pos_embed_hm"])
    w.p("final_cls_token", params["final_cls_token"])
    w.p("final_pos_embed", params["final_pos_embed"])
    _x_vit_backbone(w, params["vit_backbone"], "vit_backbone.",
                    depth=cfg.vit_depth)
    x_grid, y_grid = _heatmap_grids(cfg.heatmap_size)
    w.b("heatmap_generator.x_grid", x_grid)
    w.b("heatmap_generator.y_grid", y_grid)
    _x_lin_conv = params["heatmap_patch_embed"]["Conv_0"]
    w.p("heatmap_patch_embed.proj.weight", _conv_k(_x_lin_conv["kernel"]))
    w.p("heatmap_patch_embed.proj.bias", _x_lin_conv["bias"])
    for i in range(cfg.num_cross_modal_layers):
        _x_fusion_block(w, params[f"fusion_{i}"],
                        f"cross_modal_fusion_layers.{i}.")
    for i in range(cfg.final_encoder_depth):
        _x_encoder_block(w, params[f"final_block_{i}"], f"final_encoder.{i}.")
    _x_ln(w, params["norm_out"], "norm_out.")
    head = params["pose_head"]
    n_hidden = len(cfg.regression_hidden_dims)
    for k in range(n_hidden):
        _x_lin(w, head[f"Dense_{k}"], f"pose_head.decoder.{3 * k}.")
    _x_lin(w, head[f"Dense_{n_hidden}"],
           f"pose_head.decoder.{3 * n_hidden}.")
    return w


# -- a port checkpoint directory → a reference .pth ----------------------------

def _fresh_torch_optimizer(n_params: int, lr: float, weight_decay: float
                           ) -> Dict:
    """A momentum-free but loadable AdamW ``state_dict`` over ``n_params``
    parameters (the reference loads one unconditionally on resume); its
    ``param_groups`` schema is the installed torch's own."""
    import torch

    dummies = [torch.nn.Parameter(torch.zeros(1)) for _ in range(n_params)]
    return torch.optim.AdamW(dummies, lr=lr,
                             weight_decay=weight_decay).state_dict()


def export_torch_checkpoint(checkpoint_dir: str, out_path: str,
                            ema: bool = False, lr: float = 1e-3,
                            weight_decay: float = 0.01,
                            include_optimizer: bool = True) -> str:
    """Write a training checkpoint directory of the port as a
    reference-schema ``.pth`` (``step``, ``global_step``,
    ``model_state_dict``, ``optimizer_state_dict``, ``model_args``,
    ``model_type``): what ``pose3d_tpu.compat_export.export_torch_checkpoint``
    writes from a JAX checkpoint directory.

    The state_dict is the port model's own (reference names and order).
    The optimizer's moments and per-parameter step are the checkpoint's
    AdamW state (the port's optimizer runs over ``model.parameters()`` in
    that order); its ``param_groups`` carry ``lr`` and ``weight_decay``.
    A checkpoint whose optimizer does not cover every parameter (a frozen
    backbone) gets a momentum-free state with a warning, as in JAX.
    ``ema=True`` writes the EMA parameters and BatchNorm statistics and no
    moments (they belong to the live weights)."""
    import logging

    import torch

    from pose3d_tpu_torch.core.config import make_model_config
    from pose3d_tpu_torch.models.factory import parameter_names
    from pose3d_tpu_torch.train.checkpoint import load_checkpoint

    logger = logging.getLogger("pose3d_tpu_torch.compat_export")
    tree, meta = load_checkpoint(checkpoint_dir)
    model_type = meta["model_type"]
    n_params = len(parameter_names(make_model_config(
        model_type, **meta.get("model_args", {}))))
    sd = OrderedDict(tree["model"])
    if ema:
        if "ema_params" not in tree:
            raise ValueError(
                f"checkpoint {checkpoint_dir} carries no EMA weights "
                "(train with --ema-decay to record them)")
        sd.update(tree["ema_params"])
        # the buffers come from the averaged mirror too (an older
        # checkpoint without it: the live statistics)
        sd.update(tree.get("ema_batch_stats") or {})
    opt_sd = _fresh_torch_optimizer(n_params, lr, weight_decay)
    if include_optimizer and not ema:
        saved = tree["optimizer"]
        covered = sum(len(g["params"]) for g in saved["param_groups"])
        if covered != n_params:
            logger.warning(
                "optimizer state not exported (it covers %d of %d "
                "parameters: frozen subtrees); the reference rebuilds fresh "
                "moments", covered, n_params)
        else:
            opt_sd["state"] = {
                int(i): {"step": torch.as_tensor(s["step"],
                                                 dtype=torch.float32),
                         "exp_avg": s["exp_avg"].float(),
                         "exp_avg_sq": s["exp_avg_sq"].float()}
                for i, s in saved["state"].items()}
    step = int(meta.get("step", 0))
    model_args = dict(meta.get("model_args", {}))
    model_args.pop("model_type", None)  # the reference passes it apart
    torch.save({
        "step": step,
        "global_step": step,
        "model_state_dict": sd,
        "optimizer_state_dict": opt_sd,
        "model_args": model_args,
        "model_type": model_type,
    }, out_path)
    logger.info("Exported %s (step %d, %s%s) -> %s", checkpoint_dir, step,
                model_type, " EMA" if ema else "", out_path)
    return str(out_path)
