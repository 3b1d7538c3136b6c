"""Flash attention: the Hopper forward and backward kernels, their plain
versions, and the autograd Function that pairs them (counterpart of
``pose3d_tpu/ops/pallas/flash_attention.py``).

Forward: q ``[B, Tq, H, D]``, k ``[B, Tk, H, D]`` and v ``[B, Tk, H, Dv]``
give ``(o [B, Tq, H, Dv], lse [B, H, Tq] fp32)``:
``o = softmax(QKᵀ/√D) V`` with the softmax in fp32, and
``lse = log Σ_j exp(s_j/√D)`` per query row. The value depth Dv may differ
from D, as the TPU kernel allows (YOLO11's PSA attention: D = Dv/2).
Backward: q, k, v, o, dO and lse give ``(dq, dk, dv)`` in q's dtype, from
``P = exp(s/√D − lse)``, ``δ = rowsum(dO∘O)`` and ``dS = P∘(dO Vᵀ − δ)``.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` and
accept only CUDA tensors; :func:`flash_attention_fwd_reference` and
:func:`flash_attention_bwd_reference` are the plain PyTorch versions the
tests and ``chip_smoke.py`` hold them against. :class:`FlashAttention`
runs the kernel pair on CUDA tensors and the plain pair otherwise; its
forward reaches the kernel through one registered custom operator,
``torch.ops.pose3d_torch.flash_attention_fwd`` (CUDA: the kernel; CPU: the
plain version; a fake that gives the outputs' shapes, types and strides),
so that ``torch.export`` can trace a model that runs it and carry the
kernel inside the exported program. Each
source holds three paths, taken by the shape alone (:func:`launch_config`
mirrors the choice in plain Python, :func:`library_config` reads it back
from the built libraries): ``wgmma`` (bf16, D = Dv in {48, 64}: the
lifter's depths, TMA-fed tiles of 128 query rows or keys a block),
``wmma`` (bf16, the other pairs) and ``scalar`` (fp32).

The kernels are built for the (D, Dv) pairs in :data:`PAIRS`; like the TPU
kernel, the launchers take any D and Dv >= 1: up to 256 another pair is
zero-padded to the smallest built pair that holds it (:func:`padded_pair`),
q and k to its D, v, o and dO to its Dv, and the outputs are sliced back.
Zero columns add nothing to QKᵀ, give zero output columns and leave
δ = rowsum(dO∘O) as it was; the scale stays 1/√D of the true D. Where D or
Dv passes 256 both are padded to multiples of :data:`DEEP_CHUNK` (64) and
run on the deep instance of the ``wmma`` and ``scalar`` paths, whose
depths are a loop bound: the scores (and the backward's dP) are summed over
the depth in 64-column chunks, and the output columns are split into
slices of :data:`DEEP_SLICE` (128) across blocks, each slice recomputing
the scores in the same order (:func:`launch_config`'s ``chunk`` and
``slices``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pose3d_tpu_torch.ops.kernels import _build

# the (D, Dv) pairs the kernels are built for: D = Dv at the lifter's and
# the stage-1 models' depths, YOLO11's PSA pair (key depth half the value
# depth), D = Dv = 16 (a lifter of embed 64 over 4 heads, as the JAX
# package's lifecycle run trains) and the widest, 256; in the order of the
# C dispatch
PAIRS = ((32, 32), (48, 48), (64, 64), (128, 128), (32, 64), (16, 16),
         (256, 256))
# past depth 256 (the widest built pair), the deep instance: depths padded
# to whole chunks of DEEP_CHUNK columns, output columns in slices of
# DEEP_SLICE a block (the C attn::kDeepChunk, attn::kDeepSlice)
DEEP_CHUNK = 64
DEEP_SLICE = 128
_DEEP_KEYS = {2: 64, 4: 32}     # keys a block of the deep backward
_DTYPES = (torch.bfloat16, torch.float32)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the kernels' paths, as the C entry points number them
PATHS = ("scalar", "wmma", "wgmma")
# a block's shared-memory limit on the card
MAX_SMEM = 232448
_BLOCK = 64          # query rows (forward) or keys (backward) a block:
_THREADS = 128       # the WMMA and scalar kernels
_WG_BLOCK = 128      # the wgmma kernels: two consumer warpgroups of 64
_WG_THREADS = 384    # and a producer warpgroup
_WG_QTILE = 64       # query rows a tile of the wgmma backward
# forward: Q 16 KB + four 32 KB stages of K and V; backward: K and V 32 KB +
# two 16 KB dSᵀ buffers + four 17 KB stages of Q, dO and (lse, δ) + four
# 8 KB fp32 dQ tiles; each + barriers and 1 KB of alignment slack
_WG_SMEM_FWD = 2 * 8192 + 4 * 32768 + 128 + 1024
_WG_SMEM_BWD = 4 * 16384 + 4 * (2 * 8192 + 1024) + 4 * 8192 + 128 + 1024


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def is_deep(D: int, Dv: int) -> bool:
    """Whether (D, Dv) runs on the deep instance as it is (the C
    ``attn::deep_pair``): both multiples of :data:`DEEP_CHUNK`, one past
    256."""
    return (D >= DEEP_CHUNK and Dv >= DEEP_CHUNK and D % DEEP_CHUNK == 0
            and Dv % DEEP_CHUNK == 0 and max(D, Dv) > PAIRS[-1][0])


def padded_pair(D: int, Dv: int) -> Tuple[int, int]:
    """The pair (Dp, Dvp) that the launchers run q, k of depth D and v of
    depth Dv on, the inputs zero-padded to it: (D, Dv) itself when it is
    built, else the smallest built pair with Dp >= D and Dvp >= Dv (least
    Dp + Dvp, then least Dp); past depth 256 D and Dv each rounded up to a
    multiple of :data:`DEEP_CHUNK` (the deep instance). Raises ValueError
    for an empty depth."""
    if D < 1 or Dv < 1:
        raise ValueError(f"head dim D={D} with value depth Dv={Dv}: the "
                         "kernels take D, Dv >= 1")
    if max(D, Dv) > PAIRS[-1][0]:
        return (DEEP_CHUNK * _ceil(D, DEEP_CHUNK),
                DEEP_CHUNK * _ceil(Dv, DEEP_CHUNK))
    return min((p for p in PAIRS if p[0] >= D and p[1] >= Dv),
               key=lambda p: (p[0] + p[1], p[0]))


def slices(D: int, Dv: int) -> Tuple[int, int]:
    """(forward, backward) column slices of the pair the kernels run:
    1 and 1 on a built pair; on the deep instance ceil(Dv / 128) of o's
    columns and ceil(max(D, Dv) / 128) of dQ's, dK's and dV's (the C
    ``deep_fwd_slices`` / ``deep_bwd_slices``)."""
    if not is_deep(D, Dv):
        return 1, 1
    return _ceil(Dv, DEEP_SLICE), _ceil(max(D, Dv), DEEP_SLICE)


def _bwd_keys(D: int, Dv: int) -> int:
    """Keys a block of the backward's WMMA and fp32 kernels (the C
    ``keys_per_block``): 32 above depth 128, where 64 do not fit."""
    return 32 if max(D, Dv) > 128 else 64


def launch_config(B: int, Tq: int, Tk: int, H: int, D: int, Dv: int,
                  itemsize: int) -> dict:
    """What the two entry points do for q ``[B, Tq, H, D]``, k ``[B, Tk,
    H, D]``, v ``[B, Tk, H, Dv]`` of ``itemsize`` bytes (2: bfloat16, 4:
    float32); plain Python that mirrors the C dispatch
    (``pose3d_flash_attention_fwd_config`` / ``_bwd_config`` report the
    same from the built libraries, :func:`library_config`).

    ``path``: ``"wgmma"`` (bf16, D = Dv in {48, 64}), ``"wmma"`` (bf16,
    any other pair) or ``"scalar"`` (fp32). ``chunk``: the depth columns
    a step of the score sums takes (D on a built pair, 64 on the deep
    instance). ``fwd``: query ``rows`` a block (32 for the (256, 256) pair
    in fp32); ``bwd``: keys (``rows``) a block, 64, or 32 for the (256,
    256) pair and the deep fp32 instance; each with its ``slices`` of the
    output columns (:func:`slices`), its ``grid`` (x, y, z) = (row blocks,
    H × slices, B), dynamic shared memory ``smem`` in bytes and
    ``threads`` a block; ``scratch_floats``: the fp32 scratch the backward
    needs beside the dQ accumulator (δ, or on the wgmma path the
    interleaved (lse·log2 e, δ) rows padded to whole 64-row query tiles).
    Raises ValueError for a pair that is neither built nor deep (the
    launchers pad other pairs first: :func:`padded_pair`)."""
    if is_deep(D, Dv):
        sf, sb = slices(D, Dv)
        keys = _DEEP_KEYS[itemsize]
        c, s = DEEP_CHUNK, DEEP_SLICE
        if itemsize == 2:
            path = "wmma"
            # Q, K chunks, V slice, S, P, O (fwd); two chunks, the K, Q and
            # dO slices, S / staging, dP, P, dS, lse, δ (bwd)
            fwd = (2 * 64 * (c + 8) * 2 + 64 * (s + 8) * 2 + 64 * 68 * 4
                   + 64 * 72 * 2 + 64 * (s + 4) * 4)
            bwd = ((64 + keys) * (c + 8) * 2 + (keys + 128) * (s + 8) * 2
                   + 64 * (s + 4) * 4 + 64 * (keys + 4) * 4
                   + 2 * 64 * (keys + 8) * 2 + 2 * 64 * 4)
        else:
            path = "scalar"
            fwd = (2 * 64 * (c + 4) + 64 * (s + 4) + 64 * 65) * 4
            bwd = ((64 + keys) * (c + 4) + (keys + 128) * (s + 4)
                   + 2 * 64 * (keys + 1) + 2 * 64) * 4
        return {
            "path": path, "chunk": c, "scratch_floats": B * H * Tq,
            "fwd": {"rows": _BLOCK, "slices": sf,
                    "grid": (_ceil(Tq, _BLOCK), H * sf, B), "smem": fwd,
                    "threads": _THREADS},
            "bwd": {"rows": keys, "slices": sb,
                    "grid": (_ceil(Tk, keys), H * sb, B), "smem": bwd,
                    "threads": _THREADS},
        }
    if (D, Dv) not in PAIRS:
        raise ValueError(f"(D, Dv) = ({D}, {Dv}) is not built; pairs: "
                         f"{PAIRS}, and past depth 256 multiples of "
                         f"{DEEP_CHUNK}")
    if itemsize == 2 and D == Dv and D in (48, 64):
        path, rows, threads = "wgmma", _WG_BLOCK, _WG_THREADS
        fwd, bwd = _WG_SMEM_FWD, _WG_SMEM_BWD
        scratch = 2 * B * H * _ceil(Tq, _WG_QTILE) * _WG_QTILE
        keys = rows
    else:
        rows, threads, scratch = _BLOCK, _THREADS, B * H * Tq
        keys = _bwd_keys(D, Dv)
        if itemsize == 2:
            path = "wmma"
            fwd = (2 * 64 * (D + 8) * 2 + 64 * (Dv + 8) * 2 + 64 * 68 * 4
                   + 64 * 72 * 2 + 64 * (Dv + 4) * 4)
            # K and V tiles of `keys` rows, Q and dO of 64; S as wide as the
            # widest staging, dP as the key tile; P, dS; lse, δ
            lds = max(D, Dv, keys) + 4
            bwd = ((keys + 64) * (D + 8) * 2 + (keys + 64) * (Dv + 8) * 2
                   + 64 * lds * 4 + 64 * (keys + 4) * 4
                   + 2 * 64 * (keys + 8) * 2 + 2 * 64 * 4)
        else:
            path = "scalar"
            # above depth 128: 32 query rows a block, four threads a row,
            # the rows' q in shared memory (the C f32_rows)
            if D > 128:
                rows = 32
            fwd = (64 * (D + 4) + 64 * (Dv + 4) + rows * 65
                   + (rows * (D + 4) if D > 128 else 0)) * 4
            bwd = ((keys + 64) * (D + 4) + (keys + 64) * (Dv + 4)
                   + 2 * 64 * (keys + 1) + 2 * 64) * 4
    return {
        "path": path, "chunk": D, "scratch_floats": scratch,
        "fwd": {"rows": rows, "slices": 1, "grid": (_ceil(Tq, rows), H, B),
                "smem": fwd, "threads": threads},
        "bwd": {"rows": keys, "slices": 1, "grid": (_ceil(Tk, keys), H, B),
                "smem": bwd, "threads": threads},
    }


def library_config(B: int, Tq: int, Tk: int, H: int, D: int, Dv: int,
                   itemsize: int) -> dict:
    """:func:`launch_config` as the built libraries report it (builds
    them at first use; needs the card's toolkit)."""
    is_bf16 = int(itemsize == 2)
    fwd = (ctypes.c_int * 9)()
    lib = load_library("flash_attention_fwd")
    lib.pose3d_flash_attention_fwd_config.argtypes = [_I] * 7 + [_P]
    rc = lib.pose3d_flash_attention_fwd_config(is_bf16, B, Tq, Tk, H, D, Dv,
                                               fwd)
    bwd = _bwd_config(load_library("flash_attention_bwd"), is_bf16, B, Tq,
                      Tk, H, D, Dv)
    if rc != 0:
        raise ValueError(f"(D, Dv) = ({D}, {Dv}) is not built")
    if fwd[0] != bwd[0] or fwd[7] != bwd[8]:
        raise RuntimeError(f"forward takes path {fwd[0]} in chunks of "
                           f"{fwd[7]}, backward {bwd[0]} in chunks of "
                           f"{bwd[8]}")
    return {
        "path": PATHS[fwd[0]], "chunk": fwd[7], "scratch_floats": bwd[7],
        "fwd": {"rows": fwd[1], "slices": fwd[8], "grid": tuple(fwd[2:5]),
                "smem": fwd[5], "threads": fwd[6]},
        "bwd": {"rows": bwd[1], "slices": bwd[9], "grid": tuple(bwd[2:5]),
                "smem": bwd[5], "threads": bwd[6]},
    }


def _bwd_config(lib: ctypes.CDLL, is_bf16: int, B: int, Tq: int, Tk: int,
                H: int, D: int, Dv: int):
    """The backward's dispatch as its library reports it: path, keys a
    block, grid (3), smem, threads, scratch floats, chunk, slices."""
    out = (ctypes.c_longlong * 10)()
    lib.pose3d_flash_attention_bwd_config.argtypes = [_I] * 7 + [_P]
    rc = lib.pose3d_flash_attention_bwd_config(is_bf16, B, Tq, Tk, H, D, Dv,
                                               out)
    if rc != 0:
        raise ValueError(f"(D, Dv) = ({D}, {Dv}) is not built")
    return out


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the TPU kernel's arithmetic: fp32
    scores, max-subtracted exp with the scale (default 1/√D) folded in, e
    cast to v's dtype for PV, division deferred to the output."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp((s - m) * scale)
    denom = e.sum(dim=-1, keepdim=True)                       # [B,H,Tq,1]
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    o = o / denom.permute(0, 2, 1, 3)
    lse = (m * scale + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  do: torch.Tensor, lse: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch backward with the TPU kernel's arithmetic: fp32
    scores, P recomputed from lse in one exp (scale default 1/√D),
    δ = rowsum(dO∘O) in fp32, P cast to dO's dtype before dV and dS to q's
    dtype before dQ and dK, fp32 accumulation. Returns (dq, dk, dv) in q's
    dtype."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    f = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f))
    p = torch.exp(s * scale - lse[..., None])                 # [B,H,Tq,Tk]
    delta = (do.to(f) * o.to(f)).sum(-1).transpose(1, 2)      # [B,H,Tq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(f), do.to(f))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f), v.to(f))
    ds = (p * (dp - delta[..., None])).to(q.dtype).to(f)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f)) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernels read 16 bytes at a time and through TMA maps over
    [B, T, H, D]: the last dim must be contiguous, the base and other
    strides 16-byte aligned, and the layout row-major in that order (a
    head's row fits in the head stride, H heads in the token stride, T
    tokens in the batch stride; dims of extent 1 are not checked). Views
    that are not (none on the model's path: the packed q/k/v are) are
    copied."""
    per16 = 16 // x.element_size()
    B, T, H, D = x.shape
    sb, st, sh, sd = x.stride()
    ok = (sd == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in (sb, st, sh))
          and (H == 1 or sh >= D)
          and (T == 1 or st >= H * (sh if H > 1 else D))
          and (B == 1 or sb >= T * st))
    return x if ok else x.contiguous()


def _check(fn: str, q, k, v, **more) -> None:
    """Raise ValueError for anything the kernels do not take. ``more``
    holds the backward's o and do, which must have q's shape with v's
    depth."""
    named = {"q": q, "k": k, "v": v, **more}
    for name, x in named.items():
        if x.dim() != 4:
            raise ValueError(f"{fn}: {name} must be "
                             f"[B, T, H, D], got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{fn}: {name} is {x.dtype}; "
                             "supported: bfloat16, float32")
    if len({x.dtype for x in named.values()}) != 1:
        raise ValueError(f"{fn}: {', '.join(named)} dtypes differ")
    B, Tq, H, D = q.shape
    Dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[2] != H \
            or k.shape[3] != D:
        raise ValueError(
            f"{fn}: need k [B, Tk, H, D] and v [B, Tk, H, Dv] matching q "
            f"{tuple(q.shape)}; got k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in more.items():
        if x.shape != (B, Tq, H, Dv):
            raise ValueError(f"{fn}: {name} must have q's shape with v's "
                             f"depth {(B, Tq, H, Dv)}, got {tuple(x.shape)}")
    try:
        Dp, Dvp = padded_pair(D, Dv)
    except ValueError as e:
        raise ValueError(f"{fn}: {e}") from None
    if Tq == 0 or k.shape[1] == 0:
        raise ValueError(f"{fn}: empty query or key sequence")
    if B > 65535 or H * max(slices(Dp, Dvp)) > 65535:
        raise ValueError(f"{fn}: B and H times the column slices "
                         f"{slices(Dp, Dvp)} must be <= 65535 (grid "
                         "dimensions)")
    devices = {x.device for x in named.values()}
    if not (q.is_cuda and len(devices) == 1):
        raise ValueError(
            f"{fn}: {', '.join(named)} are on "
            f"{', '.join(str(x.device) for x in named.values())}; "
            "the kernel takes CUDA tensors on one device only")


# C signature of each library's entry point (see the extern "C" blocks)
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 7 + [ctypes.c_float]
    + [_LL] * 9 + [_P],
    "flash_attention_bwd": [_P] * 11 + [_I] * 7 + [ctypes.c_float]
    + [_LL] * 15 + [_P],
}


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library, with its
    entry point's C signature declared; idempotent."""
    return _build.load_library(name, _ARGTYPES[name])


def _pad_depth(x: torch.Tensor, depth: int) -> torch.Tensor:
    """x with its last dim zero-padded to ``depth`` (x itself if it is)."""
    if x.shape[-1] == depth:
        return x
    return torch.nn.functional.pad(x, (0, depth - x.shape[-1]))


def run_padded_fwd(launch, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``launch(q, k, v, scale) -> (o, lse)`` on the pair
    :func:`padded_pair` names, at the scale of the true D (fixed here,
    before any padding), with o sliced back to Dv. The launchers run the
    kernel through it; the tests run the plain forward through it."""
    D, Dv = q.shape[3], v.shape[3]
    scale = 1.0 / D ** 0.5
    Dp, Dvp = padded_pair(D, Dv)
    o, lse = launch(_pad_depth(q, Dp), _pad_depth(k, Dp), _pad_depth(v, Dvp),
                    scale)
    return (o if Dvp == Dv else o[..., :Dv].contiguous()), lse


def run_padded_bwd(launch, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                   lse: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``launch(q, k, v, o, do, lse, scale) -> (dq, dk, dv)`` on the built
    pair, as :func:`run_padded_fwd`: v, o and dO padded to its Dv (δ =
    rowsum(dO∘O) does not change), the gradients sliced back."""
    D, Dv = q.shape[3], v.shape[3]
    scale = 1.0 / D ** 0.5
    Dp, Dvp = padded_pair(D, Dv)
    dq, dk, dv = launch(_pad_depth(q, Dp), _pad_depth(k, Dp),
                        *(_pad_depth(x, Dvp) for x in (v, o, do)), lse, scale)
    if Dp != D:
        dq, dk = dq[..., :D].contiguous(), dk[..., :D].contiguous()
    if Dvp != Dv:
        dv = dv[..., :Dv].contiguous()
    return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream (on the pair
    :func:`padded_pair` names, the path :func:`launch_config` names for
    it). Raises on anything it does not take (non-CUDA tensors, other
    dtypes, an empty depth or key sequence) and when the launch is refused;
    it never falls back to the plain version.

    The output carries no autograd graph, so with grad mode on it raises
    for inputs that require grad: differentiate through
    :class:`FlashAttention` (``ops.attention.dot_product_attention``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd: inputs require grad, and the raw kernel "
            "would drop their gradients; call FlashAttention.apply or "
            "ops.attention.dot_product_attention instead")
    return _launch_fwd(q, k, v)


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch behind :func:`flash_attention_fwd` and the custom
    operator's CUDA implementation; counts ``flash_attention_fwd.launches``.
    Contiguous outputs, whatever the strides of q, k and v."""
    _check("flash_attention_fwd", q, k, v)
    return run_padded_fwd(_launch_fwd_built, q, k, v)


def _launch_fwd_built(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward on a built or deep pair at ``scale``."""
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, D = q.shape
    Tk, Dv = k.shape[1], v.shape[3]
    lib = load_library("flash_attention_fwd")
    o = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pose3d_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), B, Tq, Tk, H, D,
            Dv, scale,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            stream,
        )
    _build.raise_if_failed(lib, "flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


@torch.library.custom_op("pose3d_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator of PyTorch's dispatcher,
    ``torch.ops.pose3d_torch.flash_attention_fwd(q, k, v) -> (o, lse)``:
    on CUDA tensors it launches the kernel (or raises: there is no fallback),
    on CPU tensors it runs the plain version. Reached through
    :class:`FlashAttention` or under ``no_grad``: it has no autograd formula
    of its own. An exported program that holds it needs this module
    imported before it is loaded."""
    return _launch_fwd(q, k, v)


@flash_attention_fwd_op.register_kernel("cpu")
def _(q, k, v):
    o, lse = flash_attention_fwd_reference(q, k, v)
    return o.contiguous(), lse.contiguous()


@flash_attention_fwd_op.register_fake
def _(q, k, v):
    # the real outputs' shapes, types and (contiguous) strides
    B, Tq, H, _ = q.shape
    return (q.new_empty((B, Tq, H, v.shape[3])),
            q.new_empty((B, H, Tq), dtype=torch.float32))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper backward (prologue, main kernel and, for bf16,
    the dQ cast; on the pair :func:`padded_pair` names, the path
    :func:`launch_config` names for it) on PyTorch's current stream;
    returns contiguous ``(dq, dk, dv)`` in q's dtype, dv of v's depth.
    ``do`` may be any strided view (it is copied when the kernel cannot
    read it in place). Raises like :func:`flash_attention_fwd`; never
    falls back to the plain version."""
    _check("flash_attention_bwd", q, k, v, o=o, do=do)
    B, Tq, H, _ = q.shape
    if (lse.shape != (B, H, Tq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(
            f"flash_attention_bwd: lse must be float32 {(B, H, Tq)} on "
            f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    return run_padded_bwd(_launch_bwd_built, q, k, v, o, do, lse)


def _launch_bwd_built(q, k, v, o, do, lse, scale: float):
    """One backward on a built or deep pair at ``scale``; counts
    ``flash_attention_bwd.launches``."""
    B, Tq, H, D = q.shape
    Tk, Dv = k.shape[1], v.shape[3]
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    lib = load_library("flash_attention_bwd")
    dev = q.device
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Tk, H, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Tk, H, Dv), dtype=q.dtype, device=dev)
    is_bf16 = q.dtype == torch.bfloat16
    # the scratch's size from the library that will use it
    n_delta = _bwd_config(lib, int(is_bf16), B, Tq, Tk, H, D, Dv)[7]
    delta = torch.empty((n_delta,), dtype=torch.float32, device=dev)
    dq_acc = (torch.empty((B, Tq, H, D), dtype=torch.float32, device=dev)
              if is_bf16 else dq)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pose3d_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(is_bf16), B, Tq, Tk, H, D, Dv, scale,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3],
            stream,
        )
    _build.raise_if_failed(lib, "flash_attention_bwd", rc)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: ``FlashAttention.apply(q, k, v,
    use_kernel)`` → o ``[B, Tq, H, Dv]``. The forward saves q, k, v, o and
    the fp32 lse; the backward recomputes P from lse. ``use_kernel`` sends
    the forward through the custom operator (the Hopper kernel on CUDA
    tensors, its plain version on CPU ones) and the backward to the
    Hopper kernel on CUDA tensors; otherwise the plain pair runs."""

    @staticmethod
    def forward(ctx, q, k, v, use_kernel: bool):
        fwd = torch.ops.pose3d_torch.flash_attention_fwd if use_kernel \
            else flash_attention_fwd_reference
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.use_kernel = use_kernel and q.is_cuda
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        bwd = flash_attention_bwd if ctx.use_kernel else \
            flash_attention_bwd_reference
        # read once: a rematerialised block unpacks each saved tensor once
        q, k, v, o, lse = ctx.saved_tensors
        return (*bwd(q, k, v, o, do, lse), None)
