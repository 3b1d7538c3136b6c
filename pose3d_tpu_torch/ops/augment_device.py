"""Device-side pose augmentation (counterpart of
``pose3d_tpu/ops/augment_device.py``): the host augmentor's transform chain
as one batched affine resample on the device, inside the train step.

* flip → rotate → scale → translate are composed into ONE forward affine
  per sample and applied with a single bilinear (image) / nearest (depth)
  resample, instead of the host's four sequential warps;
* brightness and contrast follow, per sample;
* ``keypoints_2d`` / ``joints_3d`` are transformed with the host
  augmentor's formulas (flip maps normalized x → 1 − x while the image
  mirrors pixel x → W − 1 − x; scale multiplies normalized keypoints by f
  while the image uses the half-pixel convention of ``cv2.resize``).

Matrix conventions: each stage is a forward pixel-space map
p_dst = M p_src (``cv2.warpAffine`` semantics). The composite
M = T @ S @ R @ F is inverted analytically and the resample evaluates
src = M⁻¹ @ dst.

Resample strategies (``DeviceAugmentConfig.resample``):

* ``"separable"``: with rotation disabled the composite affine is
  axis-separable, and the warp is two batched interpolation-matrix
  products (:func:`_separable_warp`), exact bilinear / nearest, in full
  fp32 whatever the process set for TF32;
* ``"kernel"``: with rotation the per-line offsets need true dynamic
  indexing; the warp is a two-pass row resample (:func:`_twopass_warp`)
  over the hand-written ``lane_resample`` kernel. The two-pass
  decomposition carries a sub-pixel shear approximation;
* ``"gather"``: the exact single-pass resample (:func:`_gather_warp`, the
  semantics of ``map_coordinates(order, mode="constant", cval=0)``), the
  oracle of the other two;
* ``"auto"``: ``"separable"`` with rotation off, ``"kernel"`` with it on.

Randomness. The draw is separate from the arithmetic:
:func:`draw_params` draws the per-sample flip, angle, scale, translation,
brightness and contrast from a ``torch.Generator``, and
:func:`apply_params` does the rest, so a test can hand the same draws to
this module and to the JAX one. :func:`make_device_augment` returns
``augment(batch, generator)``, which calls both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from pose3d_tpu_torch.core.config import SYMMETRIC_JOINTS_H36M
from pose3d_tpu_torch.ops.kernels.lane_resample import IMPLS, resample_rows

RESAMPLE_MODES = ("auto", "separable", "kernel", "gather")


@dataclasses.dataclass(frozen=True)
class DeviceAugmentConfig:
    """Same knobs and defaults as the JAX package's ``DeviceAugmentConfig``
    (which mirror the host augmentor's ranges)."""

    rotation_range: Tuple[float, float] = (-30.0, 30.0)
    flip_prob: float = 0.5
    scale_range: Tuple[float, float] = (0.8, 1.2)
    translate_range: Tuple[float, float] = (-0.1, 0.1)
    brightness_range: Tuple[float, float] = (0.8, 1.2)
    contrast_range: Tuple[float, float] = (0.8, 1.2)
    enable_rotation: bool = True
    enable_flip: bool = True
    enable_scale: bool = True
    enable_translate: bool = True
    enable_color: bool = True
    symmetric_joints: Sequence[Tuple[int, int]] = SYMMETRIC_JOINTS_H36M
    # "auto", "separable", "kernel" or "gather": see the module docstring
    resample: str = "auto"


def _affine_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched 2x3 forward affine [[a,b,c],[d,e,f]]."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * e - b * d
    inv = torch.stack(
        [
            torch.stack([e, -b, b * f - c * e], -1),
            torch.stack([-d, a, c * d - a * f], -1),
        ],
        -2,
    )
    return inv / det[..., None, None]


def _compose(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Forward composite applying m1 first, then m2 (both [..., 2, 3]).
    The 2x2 products are written out, so no matrix-product precision
    setting reaches them."""
    r2, t2 = m2[..., :2], m2[..., 2]
    r1, t1 = m1[..., :2], m1[..., 2]
    r = (r2[..., :, :, None] * r1[..., None, :, :]).sum(-2)
    t = (r2 * t1[..., None, :]).sum(-1) + t2
    return torch.cat([r, t[..., None]], dim=-1)


def _axis_weights(pos: torch.Tensor, n: int, order: int) -> torch.Tensor:
    """Interpolation matrix [B, N_in, N_out] for per-sample-uniform 1-D
    positions ``pos`` [B, N_out]: bilinear triangle weights (order 1) or
    the floor(p + 0.5) one-hot (order 0). Out-of-range positions get
    vanishing column weight, as mode="constant", cval=0."""
    k = torch.arange(n, dtype=torch.float32, device=pos.device)[None, :, None]
    p = pos[:, None, :]
    if order == 0:
        return (torch.floor(p + 0.5) == k).float()
    return torch.clamp(1.0 - torch.abs(p - k), min=0.0)


def _fp32_exact_product(eq: str, x: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` of fp32 tensors as a full-fp32 product whatever
    the process set: outside autocast, and in fp64 (rounded back) where the
    process allows TF32 for CUDA matrix products. The order-0 weights are
    one-hot, and TF32 would cut metric depth to 10 bits of mantissa. No
    process-wide setting is written, so other threads' products keep the
    precision they asked for."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            return torch.einsum(eq, x.double(), w.double()).float()
        return torch.einsum(eq, x, w)


def _separable_warp(x: torch.Tensor, inv: torch.Tensor,
                    order: int) -> torch.Tensor:
    """Axis-separable warp of ``x`` [B, H, W, C] fp32 (``inv`` has zero
    off-diagonal linear terms) as two batched interpolation-matrix
    products: exact tensor-product bilinear / nearest in full fp32."""
    H, W = x.shape[1], x.shape[2]
    j = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=x.device)[None, :]
    px = inv[:, 0, 0:1] * j + inv[:, 0, 2:3]      # [B, W_out]
    py = inv[:, 1, 1:2] * y + inv[:, 1, 2:3]      # [B, H_out]
    wx = _axis_weights(px, W, order)              # [B, W_in, W_out]
    wy = _axis_weights(py, H, order)              # [B, H_in, H_out]
    t = _fp32_exact_product("bhwc,bwj->bhjc", x, wx)
    return _fp32_exact_product("bkjc,bky->byjc", t, wy)


def _twopass_warp(x: torch.Tensor, inv: torch.Tensor, order: int,
                  impl: str = "auto") -> torch.Tensor:
    """General affine warp of ``x`` [B, H, W, C] fp32 as two row-resample
    passes (``lane_resample``): horizontal rows first, then vertical (on
    the transposed intermediate), the classic two-pass decomposition
    (Catmull-Smith). Exact along x; the vertical pass interpolates between
    rows whose horizontal positions differ by the shear slope, a sub-pixel
    approximation bounded by |i01/i11| pixels. Requires i11 != 0 (true for
    any rotation under ±90° composed with a positive scale; flips only
    touch the x row of the matrix).

    Derivation: out[y,x] = I[y_src, x_src] with src = inv @ (x, y, 1).
    Pass 1 builds tmp[y, x] = I[y, q(x, y)], q = a*x + b*y + c with
    b = i01/i11, a = i00 - b*i10, c = i02 - b*i12; pass 2 samples
    out[y, x] = tmp[i10*x + i11*y + i12, x], so q evaluated at the
    pass-2 row equals x_src identically.

    The kernel takes contiguous rows only, so the three layout changes
    (channels before rows, the transpose between the passes, and back)
    are explicit copies here."""
    B, H, W, C = x.shape
    i00, i01, i02 = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    i10, i11, i12 = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    b = i01 / i11
    a = i00 - b * i10
    c = i02 - b * i12

    def per_row(v: torch.Tensor) -> torch.Tensor:
        """[B, L] → one value for each row of [B, C, L], materialised
        (a broadcast view has zero strides, which the kernel refuses)."""
        L = v.shape[1]
        return v[:, None, :].expand(B, C, L).reshape(-1).contiguous()

    rows = x.permute(0, 3, 1, 2).contiguous().view(B * C * H, W)
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :]
    o1 = b[:, None] * ys + c[:, None]                          # [B, H]
    a1 = per_row(a[:, None].expand(B, H))
    tmp = resample_rows(rows, a1, per_row(o1), order, impl)

    rows2 = (tmp.view(B, C, H, W).transpose(2, 3).contiguous()
             .view(B * C * W, H))
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
    o2 = i10[:, None] * xs + i12[:, None]                      # [B, W]
    a2 = per_row(i11[:, None].expand(B, W))
    out = resample_rows(rows2, a2, per_row(o2), order, impl)
    return out.view(B, C, W, H).permute(0, 3, 2, 1).contiguous()


def _gather_warp(x: torch.Tensor, inv: torch.Tensor,
                 order: int) -> torch.Tensor:
    """Exact single-pass warp of ``x`` [B, H, W, C] at the inverse-affine
    coordinates: ``map_coordinates(order, mode="constant", cval=0)`` for
    every channel. Order 1: the four taps around (floor y, floor x), a tap
    with an index outside the image contributing 0; order 0: the pixel at
    the coordinates rounded half away from zero."""
    B, H, W, C = x.shape
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    m = inv[:, :, :, None, None]                   # [B, 2, 3, 1, 1]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]     # [B, H, W]
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    flat = x.reshape(B, H * W, C)

    def tap(iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
        """x[b, iy, ix, :] where both indices are inside, else 0."""
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).view(B, H * W, 1)
        v = torch.gather(flat, 1, idx.expand(B, H * W, C)).view(B, H, W, C)
        return torch.where(valid[..., None], v, torch.zeros_like(v))

    if order == 0:
        def nearest(p):
            return torch.where(p >= 0, torch.floor(p + 0.5),
                               torch.ceil(p - 0.5)).long()
        return tap(nearest(src_y), nearest(src_x))
    ly, lx = torch.floor(src_y), torch.floor(src_x)
    uy, ux = src_y - ly, src_x - lx
    iy, ix = ly.long(), lx.long()
    out = None
    for jy, wy in ((iy, 1 - uy), (iy + 1, uy)):
        for jx, wx in ((ix, 1 - ux), (ix + 1, ux)):
            term = (wy * wx)[..., None] * tap(jy, jx)
            out = term if out is None else out + term
    return out


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32) * (hi - lo) + lo


def draw_params(cfg: DeviceAugmentConfig, batch_size: int,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Per-sample random parameters of the enabled stages, on ``device``
    (default: the generator's, and the card without a generator; the CPU
    only when asked for): ``flip`` [B] bool, ``angle`` [B] degrees,
    ``scale`` [B], ``translate`` [B, 2] as fractions of (W, H),
    ``brightness`` and ``contrast`` [B]; uniform over the config's ranges,
    flips with probability ``flip_prob``."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    B = batch_size
    p: Dict[str, torch.Tensor] = {}
    if cfg.enable_flip:
        p["flip"] = torch.rand(B, generator=generator, device=device,
                               dtype=torch.float32) < cfg.flip_prob
    if cfg.enable_rotation:
        p["angle"] = _uniform((B,), *cfg.rotation_range, generator, device)
    if cfg.enable_scale:
        p["scale"] = _uniform((B,), *cfg.scale_range, generator, device)
    if cfg.enable_translate:
        p["translate"] = _uniform((B, 2), *cfg.translate_range, generator,
                                  device)
    if cfg.enable_color:
        p["brightness"] = _uniform((B,), *cfg.brightness_range, generator,
                                   device)
        p["contrast"] = _uniform((B,), *cfg.contrast_range, generator,
                                 device)
    return p


def _resample_mode(cfg: DeviceAugmentConfig) -> str:
    mode = cfg.resample
    if mode == "auto":
        mode = "separable" if not cfg.enable_rotation else "kernel"
    if mode not in RESAMPLE_MODES:
        raise ValueError(f"unknown resample mode {mode!r}")
    if mode == "separable" and cfg.enable_rotation:
        raise ValueError("resample='separable' requires "
                         "enable_rotation=False")
    return mode


def apply_params(cfg: DeviceAugmentConfig, batch: Dict[str, torch.Tensor],
                 params: Dict, resample_impl: str = "auto"
                 ) -> Dict[str, torch.Tensor]:
    """Augment a decompacted batch {image [B,H,W,3], depth [B,H,W,1],
    keypoints_2d [B,J,2], joints_3d [B,J,3]} with the parameters of
    :func:`draw_params` (tensors or numpy arrays; an enabled stage's key
    must be there). Extra keys pass through untouched; every output keeps
    its input's dtype. ``resample_impl="reference"`` runs the two-pass
    warp on the plain ``lane_resample`` on any device."""
    if resample_impl not in IMPLS:
        raise ValueError(f"resample impl {resample_impl!r} not in {IMPLS}")
    mode = _resample_mode(cfg)
    img, depth = batch["image"], batch["depth"]
    dev = img.device
    kpts = batch["keypoints_2d"].float()
    joints = batch["joints_3d"].float()
    B, H, W = img.shape[0], img.shape[1], img.shape[2]
    wf, hf = float(W), float(H)

    def param(name: str, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(params[name]).to(device=dev, dtype=dtype)

    def const(rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.float32, device=dev)

    def rows2x3(r0, r1) -> torch.Tensor:
        return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1)], -2)

    # the swap reads the original for both halves of every pair
    perm = torch.arange(kpts.shape[1], device=dev)
    for i, k in cfg.symmetric_joints:
        perm[i], perm[k] = k, i

    ident = const([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).expand(B, 2, 3)
    mat = ident
    scale_f = torch.ones(B, dtype=torch.float32, device=dev)
    trans = torch.zeros(B, 2, dtype=torch.float32, device=dev)

    # -- flip: the image mirrors x -> W-1-x, keypoints x -> 1-x, 3D x is
    # negated, symmetric joints swap
    if cfg.enable_flip:
        do = param("flip", torch.bool)[:, None, None]
        fm = torch.where(do, const([[-1.0, 0.0, wf - 1.0], [0.0, 1.0, 0.0]]),
                         ident)
        mat = _compose(fm, mat)
        kpts = torch.where(
            do, torch.stack([1.0 - kpts[..., 0], kpts[..., 1]], -1), kpts)
        kpts = torch.where(do, kpts[:, perm], kpts)
        joints = torch.where(
            do, torch.cat([-joints[..., :1], joints[..., 1:]], -1), joints)
        joints = torch.where(do, joints[:, perm], joints)

    # -- rotation about the centre (cv2.getRotationMatrix2D) for the image
    # and the pixel-space keypoints; the 3D (x, y) plane rotates with them
    if cfg.enable_rotation:
        ang = param("angle") * (math.pi / 180.0)
        ca, sa = torch.cos(ang), torch.sin(ang)
        cx, cy = wf / 2.0, hf / 2.0
        rm = rows2x3([ca, sa, (1 - ca) * cx - sa * cy],
                     [-sa, ca, sa * cx + (1 - ca) * cy])
        mat = _compose(rm, mat)
        px = torch.stack([kpts[..., 0] * wf, kpts[..., 1] * hf,
                          torch.ones_like(kpts[..., 0])], -1)
        px = (rm[:, None, :, :] * px[:, :, None, :]).sum(-1)   # [B, J, 2]
        kpts = torch.stack([px[..., 0] / wf, px[..., 1] / hf], -1)
        r2 = rm[:, :, :2]
        xy = (r2[:, None, :, :] * joints[:, :, None, :2]).sum(-1)
        joints = torch.cat([xy, joints[..., 2:]], -1)

    # -- scale: cv2.resize by f onto a static canvas anchored top-left,
    # half-pixel convention (dst = f*src + 0.5f - 0.5); keypoints *= f
    if cfg.enable_scale:
        f = param("scale")
        off = 0.5 * f - 0.5
        zero = torch.zeros_like(f)
        mat = _compose(rows2x3([f, zero, off], [zero, f, off]), mat)
        kpts = kpts * f[:, None, None]
        scale_f = f

    # -- translation: a pixel shift; keypoints += t
    if cfg.enable_translate:
        t = param("translate")
        tx, ty = t[:, 0] * wf, t[:, 1] * hf
        one, zero = torch.ones_like(tx), torch.zeros_like(tx)
        mat = _compose(rows2x3([one, zero, tx], [zero, one, ty]), mat)
        kpts = kpts + t[:, None, :]
        trans = torch.stack([tx, ty], -1)

    if (cfg.enable_flip or cfg.enable_rotation or cfg.enable_scale
            or cfg.enable_translate):
        inv = _affine_inverse(mat)
        img, depth = img.float(), depth.float()
        if mode == "separable":
            img = _separable_warp(img, inv, order=1)
            depth = _separable_warp(depth, inv, order=0)
        elif mode == "kernel":
            img = _twopass_warp(img, inv, 1, resample_impl)
            depth = _twopass_warp(depth, inv, 0, resample_impl)
        else:
            img = _gather_warp(img, inv, order=1)
            depth = _gather_warp(depth, inv, order=0)
        if cfg.enable_scale:
            # Host parity at the scale-crop seam: the host composites the
            # resized image as canvas[:int(H*f), :int(W*f)] and zeroes
            # everything beyond, while the composed affine would keep a
            # partial last row and column. Mask the content box, shifted
            # by any later translation; min(canvas, scaled) because for
            # f > 1 the content box is the cropped canvas, so a later
            # negative translation exposes border zeros.
            cw = torch.clamp(torch.floor(wf * scale_f), max=wf)[:, None, None]
            ch = torch.clamp(torch.floor(hf * scale_f), max=hf)[:, None, None]
            xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None]
            ys = torch.arange(H, dtype=torch.float32,
                              device=dev)[None, :, None]
            inside = ((xs - trans[:, 0, None, None] < cw)
                      & (ys - trans[:, 1, None, None] < ch))[..., None]
            img = img * inside
            depth = depth * inside

    # -- color: brightness x*b, then contrast about the grayscale mean
    # (torchvision semantics)
    if cfg.enable_color:
        bright = param("brightness")[:, None, None, None]
        contrast = param("contrast")[:, None, None, None]
        img = torch.clamp(img * bright, 0.0, 1.0)
        gray = (0.2989 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2]).mean(dim=(1, 2))[:, None, None, None]
        img = torch.clamp((img - gray) * contrast + gray, 0.0, 1.0)

    out = dict(batch)
    out["image"] = img.to(batch["image"].dtype)
    out["depth"] = depth.to(batch["depth"].dtype)
    out["keypoints_2d"] = kpts.to(batch["keypoints_2d"].dtype)
    out["joints_3d"] = joints.to(batch["joints_3d"].dtype)
    return out


def make_device_augment(cfg: DeviceAugmentConfig = DeviceAugmentConfig(),
                        resample_impl: str = "auto"):
    """Build ``augment(batch, generator) -> batch`` for a decompacted batch
    on any device: :func:`draw_params` from ``generator`` (on the batch's
    device), then :func:`apply_params`. With ``resample="kernel"`` (the
    ``"auto"`` choice when rotation is on) a CUDA batch runs the
    ``lane_resample`` kernel and a CPU batch its plain version.

    ``draw_size`` and ``rows`` (a data-parallel step): draw the parameters
    of a ``draw_size``-sample batch and apply the ``rows`` of them that
    this rank's samples are, so that ranks together draw what one process
    draws for the whole batch."""
    _resample_mode(cfg)
    if resample_impl not in IMPLS:
        raise ValueError(f"resample impl {resample_impl!r} not in {IMPLS}")

    def augment(batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, *,
                draw_size: Optional[int] = None,
                rows: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        img = batch["image"]
        params = draw_params(cfg, draw_size or img.shape[0], generator,
                             img.device)
        if rows is not None:
            params = {k: v[rows] for k, v in params.items()}
        return apply_params(cfg, batch, params, resample_impl)

    return augment
