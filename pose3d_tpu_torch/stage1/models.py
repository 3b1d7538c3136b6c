"""Stage-1 networks and the batched provider (counterpart of
``pose3d_tpu/stage1/models.py``).

The reference calls two pretrained models per image: YOLO11x-pose for 17
COCO keypoints and DepthPro for metric depth. :class:`TorchStage1` (the
JAX package's ``JaxStage1``) runs them batched:

* ``kp_weights`` → :class:`YoloKeypointBackend` (``stage1/yolo11.py``):
  letterbox, forward, best person, back to the image's normalised frame;
* ``depth_weights`` → :class:`DepthProBackend` (``stage1/depthpro.py``):
  resize to 1536², normalise, forward in micro-batches of
  ``depth_max_batch``, inverse depth resized to the image, then inverted;
* otherwise the untrained native family, :class:`KeypointNet` (a
  YOLO-pose-style CSP detector with a centre and keypoint head) and
  :class:`DepthNet` (a DPT-style decoder over the same backbone), with
  random weights from an explicit ``torch.Generator``: their outputs are
  noise, for testing the pipeline (the CLIs refuse them without
  ``--allow-untrained``).

The native nets' modules carry the JAX package's flax names
(``CSPBackbone_0.ConvBN_1.Conv_0.weight``), so the bridge from its
variables (``compat.py``) is a mechanical key transform. Their compute
dtype defaults to bf16 and the ported networks' to fp32, as in the JAX
package. Host work (cv2 resizing, letterboxing) stays on the host, as
there.

Every entry point takes ``device`` (default ``"cuda"``; without CUDA it
raises unless the caller asks for the CPU). ``mesh=`` (data-parallel stage
1, a list of devices) keeps one replica of each network per device: a
batch is padded to a multiple of their count as the JAX data-parallel
provider pads it, split in order, and the outputs are gathered in order.
No process group is involved.
"""

from __future__ import annotations

import copy
import logging
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.stage1.port import resolve_device
from pose3d_tpu_torch.stage1.yolo11 import BatchNorm, cast_for_inference

logger = logging.getLogger("pose3d_tpu_torch.stage1.models")

NATIVE_DTYPE = torch.bfloat16


class ConvBN(nn.Module):
    """Conv (no bias, pad (k−1)/2) → BatchNorm (eps 1e-3) → SiLU."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel, stride,
                                (kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = BatchNorm(c_out, 1e-3)

    def forward(self, x):
        return F.silu(self.BatchNorm_0(self.Conv_0(x)))


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c_in, features, 3)
        self.ConvBN_1 = ConvBN(features, features, 3)
        self.add = c_in == features

    def forward(self, x):
        y = self.ConvBN_1(self.ConvBN_0(x))
        return x + y if self.add else y


class CSPBlock(nn.Module):
    """Cross-stage-partial block (the C2f / C3k2 family): a 1×1 conv,
    ``depth`` bottlenecks on the second half, every intermediate
    concatenated into a 1×1 conv."""

    def __init__(self, c_in: int, features: int, depth: int = 2):
        super().__init__()
        self.half = half = features // 2
        self.ConvBN_0 = ConvBN(c_in, features, 1)
        for i in range(depth):
            self.add_module(f"Bottleneck_{i}", Bottleneck(half, half))
        self.depth = depth
        self.ConvBN_1 = ConvBN((2 + depth) * half, features, 1)

    def forward(self, x):
        y = self.ConvBN_0(x)
        outs = [y[:, :self.half], y[:, self.half:]]
        b = outs[1]
        for i in range(self.depth):
            b = getattr(self, f"Bottleneck_{i}")(b)
            outs.append(b)
        return self.ConvBN_1(torch.cat(outs, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three stacked 5×5 max-pools."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        half = features // 2
        self.ConvBN_0 = ConvBN(c_in, half, 1)
        self.ConvBN_1 = ConvBN(4 * half, features, 1)

    def forward(self, x):
        pools = [self.ConvBN_0(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.ConvBN_1(torch.cat(pools, 1))


class CSPBackbone(nn.Module):
    """Strided CSP backbone → P3 (/8), P4 (/16), P5 (/32)."""

    def __init__(self, widths=(32, 64, 128, 256, 512), depths=(1, 2, 2, 1)):
        super().__init__()
        w = widths
        self.ConvBN_0 = ConvBN(3, w[0], 3, 2)
        self.ConvBN_1 = ConvBN(w[0], w[1], 3, 2)
        self.CSPBlock_0 = CSPBlock(w[1], w[1], depths[0])
        self.ConvBN_2 = ConvBN(w[1], w[2], 3, 2)
        self.CSPBlock_1 = CSPBlock(w[2], w[2], depths[1])
        self.ConvBN_3 = ConvBN(w[2], w[3], 3, 2)
        self.CSPBlock_2 = CSPBlock(w[3], w[3], depths[2])
        self.ConvBN_4 = ConvBN(w[3], w[4], 3, 2)
        self.CSPBlock_3 = CSPBlock(w[4], w[4], depths[3])
        self.SPPF_0 = SPPF(w[4], w[4])

    def forward(self, x):
        x = self.CSPBlock_0(self.ConvBN_1(self.ConvBN_0(x)))
        p3 = self.CSPBlock_1(self.ConvBN_2(x))
        p4 = self.CSPBlock_2(self.ConvBN_3(p3))
        p5 = self.SPPF_0(self.CSPBlock_3(self.ConvBN_4(p4)))
        return p3, p4, p5


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class KeypointNet(nn.Module):
    """2D keypoint detector (YOLO-pose class). ``forward(images [B, 3, H,
    W]`` in [0, 1]) → ``(kpts [B, J, 3]`` best person (norm_x, norm_y,
    conf), ``heads)``, heads per stride 8, 16, 32: ``(obj [B, h, w], kpt
    [B, h, w, J, 3])`` fp32."""

    def __init__(self, num_joints: int = 17,
                 widths=(32, 64, 128, 256, 512),
                 dtype: torch.dtype = NATIVE_DTYPE):
        super().__init__()
        self.num_joints = num_joints
        self.dtype = dtype
        w = widths
        self.CSPBackbone_0 = CSPBackbone(w)
        self.CSPBlock_0 = CSPBlock(2 * w[3], w[3], 1)
        self.ConvBN_0 = ConvBN(w[4], w[3], 1)
        self.CSPBlock_1 = CSPBlock(2 * w[2], w[2], 1)
        self.ConvBN_1 = ConvBN(w[3], w[2], 1)
        for i, width in enumerate((w[2], w[3], w[4])):
            self.add_module(f"ConvBN_{2 + i}", ConvBN(width, width, 3))
            self.add_module(f"Conv_{2 * i}", nn.Conv2d(width, 1, 1))
            self.add_module(f"Conv_{2 * i + 1}",
                            nn.Conv2d(width, 3 * num_joints, 1))

    def fp32_modules(self) -> List[nn.Module]:
        return [getattr(self, f"Conv_{i}") for i in range(6)]

    def forward(self, images):
        p3, p4, p5 = self.CSPBackbone_0(images.to(self.dtype))
        t4 = self.CSPBlock_0(torch.cat([_up2(self.ConvBN_0(p5)), p4], 1))
        t3 = self.CSPBlock_1(torch.cat([_up2(self.ConvBN_1(t4)), p3], 1))
        heads = []
        for i, feat in enumerate((t3, t4, p5)):
            h = getattr(self, f"ConvBN_{2 + i}")(feat).float()
            obj = getattr(self, f"Conv_{2 * i}")(h)[:, 0]
            kpt = getattr(self, f"Conv_{2 * i + 1}")(h)
            B, _, hs, ws = kpt.shape
            heads.append((obj, kpt.permute(0, 2, 3, 1)
                          .reshape(B, hs, ws, self.num_joints, 3)))
        return decode_best_person(heads), heads


def _flatten_heads(heads):
    """Per-scale heads → (obj [B, N], centres [B, N, 2] normalised,
    kpts [B, N, J, 3]: normalised coordinates and confidence logits)."""
    objs, centers, kpts = [], [], []
    for obj, kpt in heads:
        B, hs, ws = obj.shape
        dev = obj.device
        cy = (torch.arange(hs, dtype=torch.float32, device=dev) + 0.5) / hs
        cx = (torch.arange(ws, dtype=torch.float32, device=dev) + 0.5) / ws
        gx, gy = torch.meshgrid(cx, cy, indexing="xy")       # [h, w] each
        px = gx[None, :, :, None] + kpt[..., 0] / ws
        py = gy[None, :, :, None] + kpt[..., 1] / hs
        k = torch.stack([px, py, kpt[..., 2]], dim=-1)
        objs.append(obj.reshape(B, -1))
        centers.append(torch.stack([gx, gy], dim=-1)[None]
                       .expand(B, hs, ws, 2).reshape(B, -1, 2))
        kpts.append(k.reshape(B, hs * ws, -1, 3))
    return torch.cat(objs, 1), torch.cat(centers, 1), torch.cat(kpts, 1)


def decode_best_person(heads):
    """The highest-objectness cell over all scales → [B, J, 3]; ties go to
    the lower index, as ``jnp.argmax``."""
    obj, _, kpts = _flatten_heads(heads)
    best = torch.argmax(obj, dim=1)
    b = torch.arange(obj.shape[0], device=obj.device)
    sel = kpts[b, best]
    conf_obj = torch.sigmoid(obj.max(dim=1).values)
    conf = torch.sigmoid(sel[..., 2]) * conf_obj[:, None]
    return torch.stack([sel[..., 0], sel[..., 1], conf], dim=-1).float()


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_persons(heads, max_persons: int = 5, conf_threshold: float = 0.25,
                   nms_radius: float = 0.1):
    """Multi-person decode: the top 4·max_persons objectness cells over
    all scales, greedy centre NMS → ``(persons [B, P, J, 3], person_conf
    [B, P])``; suppressed or sub-threshold slots have conf 0."""
    obj, centers, kpts = _flatten_heads(heads)
    B = obj.shape[0]
    K = max_persons * 4
    scores, idx = _top_k(obj, K)
    bidx = torch.arange(B, device=obj.device)[:, None]
    cand_c = centers[bidx, idx]
    cand_k = kpts[bidx, idx]
    cand_s = torch.sigmoid(scores)
    keep = torch.ones((B, K), dtype=torch.bool, device=obj.device)
    later = torch.arange(K, device=obj.device)
    for i in range(K):
        d = torch.linalg.norm(cand_c - cand_c[:, i:i + 1], dim=-1)
        keep = keep & ~((d < nms_radius) & (later > i)[None]
                        & keep[:, i:i + 1])
    final_s = torch.where(keep & (cand_s >= conf_threshold), cand_s,
                          torch.zeros_like(cand_s))
    top_s, top_i = _top_k(final_s, max_persons)
    sel_k = cand_k[bidx, top_i]
    conf = torch.sigmoid(sel_k[..., 2]) * top_s[..., None]
    persons = torch.stack([sel_k[..., 0], sel_k[..., 1], conf], dim=-1)
    return persons.float(), top_s.float()


class DepthNet(nn.Module):
    """Monocular metric depth, a DPT-style decoder over the CSP backbone.
    ``forward(images [B, 3, H, W])`` → metric depth [B, H, W] fp32
    (softplus-positive inverse depth, a learned positive scale and
    shift)."""

    def __init__(self, widths=(32, 64, 128, 256, 512), fusion_dim: int = 128,
                 dtype: torch.dtype = NATIVE_DTYPE):
        super().__init__()
        self.dtype = dtype
        w, f = widths, fusion_dim
        self.CSPBackbone_0 = CSPBackbone(w)
        self.ConvBN_0 = ConvBN(w[4], f, 1)
        self.ConvBN_1 = ConvBN(w[3], f, 1)
        self.CSPBlock_0 = CSPBlock(f, f, 1)
        self.ConvBN_2 = ConvBN(w[2], f, 1)
        self.CSPBlock_1 = CSPBlock(f, f, 1)
        self.ConvBN_3 = ConvBN(f, f // 2, 3)
        self.ConvBN_4 = ConvBN(f // 2, f // 4, 3)
        self.Conv_0 = nn.Conv2d(f // 4, 1, 3, padding=1)
        self.depth_scale = nn.Parameter(torch.ones(()))
        self.depth_shift = nn.Parameter(torch.zeros(()))

    def fp32_modules(self) -> List[nn.Module]:
        return [self.Conv_0]

    def forward(self, images):
        p3, p4, p5 = self.CSPBackbone_0(images.to(self.dtype))
        x = _up2(self.ConvBN_0(p5)) + self.ConvBN_1(p4)
        x = _up2(self.CSPBlock_0(x)) + self.ConvBN_2(p3)
        x = _up2(self.CSPBlock_1(x))                                  # /4
        x = _up2(self.ConvBN_3(x))                                    # /2
        x = _up2(self.ConvBN_4(x))                                    # /1
        inv = self.Conv_0(x.float())[:, 0]
        inv_depth = (F.softplus(inv) * F.softplus(self.depth_scale.float())
                     + 1e-3)
        return 1.0 / inv_depth + F.softplus(self.depth_shift.float())


@torch.no_grad()
def init_native(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation: conv kernels LeCun-normal (truncated
    at ±2σ, σ = 1/√fan_in corrected for the truncation), biases 0,
    BatchNorm scale 1, shift 0 and statistics (0, 1); the depth scale 1
    and shift 0. Draws from ``generator`` (a CPU generator)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return model


def _square_resize_batch(images: Sequence[np.ndarray], size: int
                         ) -> np.ndarray:
    import cv2

    out = np.stack([cv2.resize(im, (size, size),
                               interpolation=cv2.INTER_LINEAR)
                    for im in images])
    if out.dtype == np.uint8:
        out = out.astype(np.float32) / 255.0
    return out.astype(np.float32)


def _nchw(batch: np.ndarray, device) -> torch.Tensor:
    """[B, H, W, 3] host images → a [B, 3, H, W] tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(batch)).to(
        device).permute(0, 3, 1, 2)


def _pad_rows(batch: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the batch up to a multiple of ``multiple`` (the replicas) by
    repeating its last row, as the JAX data-parallel provider does."""
    if multiple <= 1 or len(batch) % multiple == 0:
        return batch
    pad = multiple - len(batch) % multiple
    return np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])


class _Replicas:
    """One copy of ``model`` per device of ``devices`` (the first is
    ``model`` itself). :meth:`run` splits a batch whose rows are a
    multiple of their count in order over them, each part through its
    copy, and concatenates the outputs in order on the host; every part
    is launched before any is read back."""

    def __init__(self, model: nn.Module, devices):
        self.devices = list(devices)
        self.models = [model] + [copy.deepcopy(model).to(d)
                                 for d in self.devices[1:]]

    def __len__(self):
        return len(self.models)

    @torch.inference_mode()
    def run(self, batch: np.ndarray, fn):
        parts = np.split(batch, len(self.models))
        outs = [fn(m, _nchw(p, d))
                for m, d, p in zip(self.models, self.devices, parts)]
        return tuple(torch.cat([o[k].cpu() for o in outs]).numpy()
                     for k in range(len(outs[0])))


def _native(model: nn.Module, state_dict, generator, device, dtype):
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_native(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    return cast_for_inference(model, dtype).to(device)


class NativeKeypointBackend:
    """KeypointNet over square-resized inputs (the untrained family)."""

    def __init__(self, num_joints: int, input_size: int, params=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: torch.dtype = NATIVE_DTYPE,
                 devices=None):
        self.num_joints = num_joints
        self.input_size = input_size
        self.device = resolve_device(device)
        self.model = _native(KeypointNet(num_joints), params, generator,
                             self.device, dtype)
        self.replicas = _Replicas(self.model, devices or [self.device])

    def predict(self, images: Sequence[np.ndarray]) -> np.ndarray:
        batch = _pad_rows(_square_resize_batch(images, self.input_size),
                          len(self.replicas))
        kpts, = self.replicas.run(batch, lambda m, x: m(x)[:1])
        return kpts[:len(images)]


class YoloKeypointBackend:
    """YOLO11-pose: letterbox (fill 114/255) → forward → best person →
    back to each image's normalised frame; a best box under
    ``box_conf_threshold`` gives zeros (nothing detected), and a (J, 2)
    checkpoint's keypoints get confidence 1."""

    def __init__(self, weights, input_size: int = 640,
                 box_conf_threshold: float = 0.25, dtype=None, device="cuda",
                 devices=None):
        from pose3d_tpu_torch.stage1.yolo_port import load_yolo11_pose

        self.input_size = input_size
        self.box_conf_threshold = box_conf_threshold
        self.device = resolve_device(device)
        self.model = load_yolo11_pose(
            weights, dtype=dtype if dtype is not None else torch.float32,
            device=self.device)
        self.num_joints = self.model.kpt_shape[0]
        self.replicas = _Replicas(self.model, devices or [self.device])

    def _forward(self, batch: np.ndarray):
        from pose3d_tpu_torch.stage1.yolo11 import best_person_keypoints

        def fn(model, x):
            kp, conf = best_person_keypoints(model(x), self.input_size,
                                             kpt_shape=model.kpt_shape)
            if kp.shape[-1] == 2:
                kp = torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)
            return kp, conf

        return self.replicas.run(batch, fn)

    def predict(self, images: Sequence[np.ndarray]) -> np.ndarray:
        import cv2

        from pose3d_tpu_torch.stage1.yolo11 import letterbox_params

        s = self.input_size
        m = len(self.replicas)
        n_rows = -(-len(images) // m) * m  # letterbox-filled padding rows
        batch = np.full((n_rows, s, s, 3), 114 / 255.0, np.float32)
        geoms = []
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            r, nw, nh, left, top = letterbox_params(h, w, s)
            resized = cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
            if resized.dtype == np.uint8:
                resized = resized.astype(np.float32) / 255.0
            batch[i, top:top + nh, left:left + nw] = resized
            geoms.append((r, left, top, w, h))
        kp, conf = self._forward(batch)
        out = np.zeros((len(images), self.num_joints, 3), np.float32)
        for i, (r, left, top, w, h) in enumerate(geoms):
            if conf[i] < self.box_conf_threshold:
                continue  # no person detected: zeros
            x = (kp[i, :, 0] * s - left) / r / w
            y = (kp[i, :, 1] * s - top) / r / h
            out[i] = np.stack([np.clip(x, 0, 1), np.clip(y, 0, 1),
                               kp[i, :, 2]], axis=-1)
        return out


class NativeDepthBackend:
    """DepthNet over square-resized inputs (the untrained family), each
    map resized back to its image."""

    def __init__(self, input_size: int, params=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: torch.dtype = NATIVE_DTYPE,
                 devices=None):
        self.input_size = input_size
        self.device = resolve_device(device)
        self.model = _native(DepthNet(), params, generator, self.device,
                             dtype)
        self.replicas = _Replicas(self.model, devices or [self.device])

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        import cv2

        batch = _pad_rows(_square_resize_batch(images, self.input_size),
                          len(self.replicas))
        depths, = self.replicas.run(batch, lambda m, x: (m(x),))
        return [cv2.resize(depths[i], (im.shape[1], im.shape[0]),
                           interpolation=cv2.INTER_LINEAR)
                for i, im in enumerate(images)]


class DepthProBackend:
    """DepthPro: resize to ``input_size``² and (x − 0.5)/0.5 → forward in
    micro-batches of ``max_batch`` (a short one padded by repeating its
    last image) → FOV-calibrated inverse depth, resized to the image on the
    host and then inverted (HF's order)."""

    def __init__(self, weights, input_size: int = 1536, max_batch: int = 2,
                 dtype=None, device="cuda", devices=None):
        from pose3d_tpu_torch.stage1.depthpro_port import load_depth_pro

        self.input_size = input_size
        n_dev = len(devices) if devices else 1
        if n_dev > 1:
            # every call pads to max_batch, so align it with the replicas
            max_batch = max(max_batch, n_dev)
            max_batch -= max_batch % n_dev
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.model = load_depth_pro(
            weights, dtype=dtype if dtype is not None else torch.float32,
            image_size=input_size, device=self.device)
        self.replicas = _Replicas(self.model, devices or [self.device])

    def _forward(self, batch: np.ndarray) -> np.ndarray:
        from pose3d_tpu_torch.stage1.depthpro import fov_scaled_inverse_depth

        out, = self.replicas.run(batch, lambda m, x: (
            fov_scaled_inverse_depth(*m(x)).float(),))
        return out

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        import cv2

        s = self.input_size
        canonical = []
        for i in range(0, len(images), self.max_batch):
            chunk = images[i:i + self.max_batch]
            batch = np.stack([cv2.resize(im, (s, s),
                                         interpolation=cv2.INTER_LINEAR)
                              for im in chunk])
            if batch.dtype == np.uint8:
                batch = batch.astype(np.float32) / 255.0
            batch = (batch.astype(np.float32) - 0.5) / 0.5
            n = len(chunk)
            if n < self.max_batch:
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], self.max_batch - n, 0)])
            canonical.extend(self._forward(batch)[:n])
        results = []
        for im, d in zip(images, canonical):
            h, w = im.shape[:2]
            d = cv2.resize(d, (w, h), interpolation=cv2.INTER_LINEAR)
            results.append(1.0 / np.clip(d, 1e-4, 1e4))
        return results


class TorchStage1:
    """Batched stage-1 provider (the JAX package's ``JaxStage1``, with the
    same arguments; ``generator`` in place of ``rng``, plus ``device``):

    * ``kp_weights`` → :class:`YoloKeypointBackend`, else
      :class:`NativeKeypointBackend` (``keypoint_params``: its
      state_dict);
    * ``depth_weights`` → :class:`DepthProBackend`, else
      :class:`NativeDepthBackend` (``depth_params``).

    ``dtype`` is the ported networks' compute dtype (default fp32).
    ``confidence_threshold`` zeroes the keypoints below it (confidence 0
    marks a keypoint invalid downstream). ``mesh``: the devices of a
    data-parallel provider (one replica of each network on each, the first
    in place of ``device``; module docstring)."""

    def __init__(self, num_joints: int = 17, input_size: int = 512,
                 keypoint_params=None, depth_params=None,
                 generator: Optional[torch.Generator] = None,
                 confidence_threshold: float = 0.0, kp_weights=None,
                 depth_weights=None, kp_input_size: int = 640,
                 depth_input_size: int = 1536, depth_max_batch: int = 2,
                 dtype=None, mesh=None, device="cuda"):
        if mesh is not None and (not isinstance(mesh, (list, tuple))
                                 or not mesh):
            raise TypeError(f"mesh= is a non-empty list of devices (one "
                            f"replica of each network on each), not {mesh!r}")
        devices = ([resolve_device(d) for d in mesh]
                   if mesh is not None else None)
        self.num_joints = num_joints
        self.input_size = input_size
        self.confidence_threshold = confidence_threshold
        self.device = devices[0] if devices else resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if kp_weights:
            self._kp = YoloKeypointBackend(
                kp_weights, input_size=kp_input_size, dtype=dtype,
                device=self.device, devices=devices)
            if self._kp.num_joints != num_joints:
                logger.warning("keypoint weights predict %d joints, the "
                               "pipeline expects %d", self._kp.num_joints,
                               num_joints)
        else:
            self._kp = NativeKeypointBackend(
                num_joints, input_size, params=keypoint_params,
                generator=generator, device=self.device, devices=devices)
        if depth_weights:
            self._depth = DepthProBackend(
                depth_weights, input_size=depth_input_size,
                max_batch=depth_max_batch, dtype=dtype, device=self.device,
                devices=devices)
        else:
            self._depth = NativeDepthBackend(
                input_size, params=depth_params, generator=generator,
                device=self.device, devices=devices)

    @property
    def kp_model(self) -> nn.Module:
        return self._kp.model

    @property
    def depth_model(self) -> nn.Module:
        return self._depth.model

    def predict_batch(self, images: Sequence[np.ndarray]):
        """images: ``[H, W, 3]`` uint8 or float RGB → one Stage1Result each:
        keypoints ``[J, 3]`` and metric depth at the image's resolution."""
        from pose3d_tpu_torch.stage1.api import Stage1Result

        kpts = self._kp.predict(images)[:, :self.num_joints]
        if kpts.shape[1] < self.num_joints:
            pad = np.zeros((len(images), self.num_joints - kpts.shape[1], 3),
                           np.float32)
            kpts = np.concatenate([kpts, pad], axis=1)
        if self.confidence_threshold > 0:
            kpts = kpts.copy()
            kpts[kpts[..., 2] < self.confidence_threshold] = 0.0
        depths = self._depth.predict(images)
        results = []
        for i in range(len(images)):
            d = depths[i].astype(np.float32)
            results.append(Stage1Result(
                keypoints=kpts[i].astype(np.float32), depth=d,
                depth_min=float(d.min()), depth_max=float(d.max())))
        return results

    def predict_one(self, image_path, image: Optional[np.ndarray] = None):
        if image is None:
            import cv2

            bgr = cv2.imread(str(image_path), cv2.IMREAD_COLOR)
            if bgr is None:
                return None
            image = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        return self.predict_batch([image])[0]

    def predict(self, image_paths, images=None):
        if images is not None:
            return self.predict_batch(images)
        return [self.predict_one(p) for p in image_paths]
