"""The transformer MLP core, Linear → exact GELU → Linear, as one fused op:
the Hopper forward and backward kernels, their plain versions, and the
autograd Function that pairs them (counterpart of
``pose3d_tpu/ops/pallas/mlp_block.py``).

Forward: ``x`` ``[..., D]`` (bf16 or fp32), ``w1`` ``[D, H]``, ``b1``
``[H]``, ``w2`` ``[H, D]``, ``b2`` ``[D]`` (the JAX layout: ``x @ w1``) give
``out = gelu(x·w1 + b1)·w2 + b2`` in x's dtype. Both products accumulate
in fp32 from operands in x's dtype (the weights are cast outside the
kernel, as in JAX); ``a = x·w1 + b1`` stays fp32; GELU is
``a·½·(1 + erf(a/√2))`` with erf by Abramowitz–Stegun 7.1.26 (the TPU
kernel's polynomial, max error 1.5e-7); ``gelu(a)`` is rounded to x's dtype
before the second product. The ``[N, H]`` hidden activation never reaches
device memory.
Backward: the hidden is recomputed from x; ``dga = g·w2ᵀ`` (fp32),
``da = dga·(Φ(a) + a·φ(a))`` rounded to x's dtype, ``dx = da·w1ᵀ``,
``dw1 = xᵀ·da``, ``db1 = Σ da`` (of the rounded da), ``dw2 = gelu(a)ᵀ·g``,
``db2 = Σ g``, all accumulated in fp32 and returned in each parameter's own
dtype.

:func:`mlp_block_fwd` and :func:`mlp_block_bwd` launch
``csrc/mlp_block_fwd.cu`` and ``csrc/mlp_block_bwd.cu`` and accept only
CUDA tensors; :func:`mlp_block_fwd_reference` and
:func:`mlp_block_bwd_reference` are the plain PyTorch versions the tests
and ``chip_smoke.py`` hold them against. :func:`fused_mlp` is the
differentiable op: the kernel pair for a CUDA tensor, the plain pair for a
CPU tensor or when asked for by ``impl="reference"``. No model calls it
(as in the JAX package, where the op stands alone); :func:`mlp_params`
carries a module's parameters across.

Widths: like the TPU kernel, the launchers take any D and H. The kernels
take multiples of 16; other widths are zero-padded to them
(:func:`run_padded_fwd`): padded hidden units have zero weights and bias,
GELU(0) = 0, so they add nothing, and padded columns of D are sliced off
every output. Above 768 the WMMA and fp32 kernels split D's output columns
across blocks (``slices`` in :func:`launch_config`), each block still
summing x·w1 and g·w2ᵀ over all of D before the GELU; above 1,280 they
stream D through shared memory in chunks (``chunks``), summing over the
chunks in order, in fp32, before the GELU.

The plain versions round only where the kernels round: a bf16
``torch.matmul`` would return bf16 and so round ``a`` before the GELU and
``dga`` before its product, hence every product here is taken in fp32 of
operands already rounded to x's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels._launch import (
    on_device,
    refuse_grad_inputs,
    rows_view,
)

IMPLS = ("auto", "reference")
_DTYPES = (torch.bfloat16, torch.float32)
# the widest D a block holds whole in shared memory (ViT-H's); wider D is
# streamed in chunks of at most this many columns (the C kMaxChunk)
MAX_CHUNK = 1280
# a block keeps its [rows, cols] output tile in registers (two warpgroups
# with a 384-column slab each; six 16-column fragments to each of eight
# warps on the WMMA path): at most 768 columns, so wider D is split into
# column slices (the wgmma kernels keep D <= 768)
MAX_COLS = 768

# the kernels' paths, as the C entry points number them
PATHS = ("scalar", "wmma", "wgmma")
# a block's shared-memory limit on the card
MAX_SMEM = 232448
_SMS = 132           # the row split is fixed for this count, not read from
                     # the card: a shape's gradients are the same on any card
_WG_ROWS = 64        # rows a block: forward and dx (wgmma)
_WG_TILE = 128       # rows a tile of the dW kernel, 64 a warpgroup
_WG_COLS = 32        # hidden columns a block of the dW kernel
# x tile 96 KB + two chunk buffers + (dx: 16 KB of parked gelu') + four
# 24 KB stages; dW: 96 KB of weights + five 16 KB stages + ga, da, parked
# gelu', db1's strips; each + barriers and 1 KB of alignment slack
_WG_SMEM_FWD = 98304 + 2 * 8192 + 4 * 24576 + 128 + 1024
_WG_SMEM_DX = 98304 + 2 * 8192 + 16384 + 4 * 24576 + 128 + 1024
_WG_SMEM_DW = 98304 + 5 * 16384 + 2 * 8192 + 16384 + 1024 + 128 + 1024

_SQRT_HALF = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "mlp_block_fwd": [_P] * 6 + [_I, _LL, _I, _I, _P],
    "mlp_block_bwd": [_P] * 11 + [_LL, _I, _LL, _I, _I, _P],
}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def padded_widths(D: int, H: int) -> Tuple[int, int]:
    """(Dp, Hp): D and H rounded up to the multiples of 16 the kernels
    run on (the inputs zero-padded to them)."""
    return 16 * _ceil(D, 16), 16 * _ceil(H, 16)


def _split(D: int, most: int) -> Tuple[int, int]:
    n = _ceil(D, most)
    return n, 16 * _ceil(D, 16 * n)


def column_slices(D: int) -> Tuple[int, int]:
    """(slices, cols): the kernels' split of D's output columns, at most
    :data:`MAX_COLS` a block, ``cols`` a multiple of 16 (the last slice
    may be narrower); (1, D) up to 768. Mirrors the C ``column_slices``."""
    return _split(D, MAX_COLS)


def depth_chunks(D: int) -> Tuple[int, int]:
    """(chunks, cols): the chunks the WMMA and fp32 kernels stream D
    through shared memory in, at most :data:`MAX_CHUNK` columns each, in
    the same way as :func:`column_slices`; (1, D) up to 1,280. Mirrors the
    C ``depth_chunks``."""
    return _split(D, MAX_CHUNK)


def launch_config(N: int, D: int, H: int, itemsize: int) -> dict:
    """What the two entry points do for ``x`` ``[N, D]`` of ``itemsize``
    bytes (2: bfloat16, 4: float32) and hidden width ``H``; plain Python
    that mirrors the C dispatch (``pose3d_mlp_block_fwd_config`` /
    ``_bwd_config`` report the same from the built library,
    :func:`library_config`).

    ``padded``: (Dp, Hp), the widths the kernels run on
    (:func:`padded_widths`); everything below is for them. ``slices``,
    ``cols``: D's output columns split across blocks (:func:`column_slices`;
    one slice up to 768). ``chunks``: (chunks, columns a chunk) that D is
    streamed in (:func:`depth_chunks`; (1, D) up to 1,280). ``path``:
    ``"wgmma"`` (bf16, Dp a multiple of 64
    up to 768: TMA-fed ``wgmma`` kernels), ``"wmma"`` (bf16, any other Dp:
    the WMMA kernels) or ``"scalar"`` (fp32). ``fwd`` / ``dx`` / ``dw``:
    ``rows`` a block (a tile for ``dw``), ``blocks`` (times the slices),
    ``smem`` bytes of dynamic shared memory;
    ``groups``: the dW kernel's row groups G (its grid is
    ``ceil(H / 32) × G``, about three waves of the card's 132 SMs, no
    group empty; 1 off the wgmma path); ``scratch_bytes``: fp32 scratch
    the backward needs (G partials ``[dW1 | dW2 | db1]`` and db2's
    per-row-block column sums; :func:`mlp_block_bwd` allocates what the
    library itself reports, which ``chip_smoke.py`` holds equal to this)."""
    D, H = padded_widths(D, H)
    widths = {"padded": (D, H)}
    if itemsize == 2 and D % 64 == 0 and D <= MAX_COLS:
        cblocks, tiles = _ceil(H, _WG_COLS), _ceil(N, _WG_TILE)
        g = max(1, min(tiles, (3 * _SMS) // cblocks))
        groups = _ceil(tiles, _ceil(tiles, g))
        rows2 = max(64, _ceil(N, 256))
        scratch = groups * (2 * D * H + H) + _ceil(N, rows2) * D
        return {
            **widths, "slices": 1, "cols": D, "chunks": (1, D),
            "path": "wgmma", "groups": groups, "scratch_bytes": 4 * scratch,
            "fwd": {"rows": _WG_ROWS, "blocks": _ceil(N, _WG_ROWS),
                    "smem": _WG_SMEM_FWD},
            "dx": {"rows": _WG_ROWS, "blocks": _ceil(N, _WG_ROWS),
                   "smem": _WG_SMEM_DX},
            "dw": {"rows": _WG_TILE, "blocks": cblocks * groups,
                   "smem": _WG_SMEM_DW},
        }
    n, cols = column_slices(D)
    chunks = depth_chunks(D)
    W = chunks[1]       # x's (and g's) columns a block holds at once
    dw_rows = 32
    if itemsize == 2:
        fwd = 32 * (W + 8) * 2 + 32 * 132 * 4 + 32 * 136 * 2
        dx = 2 * 32 * (W + 8) * 2 + 2 * 32 * 68 * 4 + 32 * 72 * 2
        dw = 2 * 32 * (W + 8) * 2 + 4 * 32 * 20 * 4 + 2 * 32 * 24 * 2
        rows, path = 32, "wmma"
    else:
        # x (and g) [16, W], the block's output columns [16, cols], chunks
        fwd = (16 * W + 16 * cols + 16 * 64) * 4
        dx = (2 * 16 * W + 16 * cols + 2 * 16 * 64) * 4
        # x and g tiles of 32 rows, or of 16 where those do not fit
        if (2 * 32 * W + 2 * 32 * 16) * 4 > MAX_SMEM:
            dw_rows = 16
        dw = (2 * dw_rows * W + 2 * dw_rows * 16) * 4
        rows, path = 16, "scalar"
    return {
        **widths, "slices": n, "cols": cols, "chunks": chunks,
        "path": path, "groups": 1, "scratch_bytes": 0,
        "fwd": {"rows": rows, "blocks": _ceil(N, rows) * n, "smem": fwd},
        "dx": {"rows": rows, "blocks": _ceil(N, rows) * n, "smem": dx},
        "dw": {"rows": dw_rows, "blocks": H // 16 * n, "smem": dw},
    }


def _bwd_config(lib: ctypes.CDLL, is_bf16: int, N: int, D: int, H: int):
    """The backward's dispatch as its library reports it: path, dx rows,
    blocks, smem, dW rows, blocks, groups, smem, scratch floats, column
    slices, depth chunks, columns a chunk (for the padded widths)."""
    out = (ctypes.c_longlong * 12)()
    lib.pose3d_mlp_block_bwd_config.argtypes = [_I, _LL, _I, _I, _P]
    lib.pose3d_mlp_block_bwd_config(is_bf16, N, D, H, out)
    return out


def library_config(N: int, D: int, H: int, itemsize: int) -> dict:
    """:func:`launch_config` as the built libraries report it (builds
    them at first use; needs the card's toolkit)."""
    fwd = (ctypes.c_int * 8)()
    is_bf16 = int(itemsize == 2)
    D, H = padded_widths(D, H)
    lib = load_library("mlp_block_fwd")
    lib.pose3d_mlp_block_fwd_config.argtypes = [_I, _LL, _I, _I, _P]
    lib.pose3d_mlp_block_fwd_config(is_bf16, N, D, H, fwd)
    bwd = _bwd_config(load_library("mlp_block_bwd"), is_bf16, N, D, H)
    if (fwd[0], fwd[4], fwd[6]) != (bwd[0], bwd[9], bwd[10]):
        raise RuntimeError(f"forward takes path {fwd[0]} over {fwd[4]} "
                           f"slices and {fwd[6]} chunks, backward {bwd[0]} "
                           f"over {bwd[9]} and {bwd[10]}")
    return {
        "padded": (D, H), "slices": fwd[4], "cols": fwd[5],
        "chunks": (fwd[6], fwd[7]),
        "path": PATHS[fwd[0]], "groups": bwd[6], "scratch_bytes": 4 * bwd[8],
        "fwd": {"rows": fwd[1], "blocks": fwd[2], "smem": fwd[3]},
        "dx": {"rows": bwd[1], "blocks": bwd[2], "smem": bwd[3]},
        "dw": {"rows": bwd[4], "blocks": bwd[5], "smem": bwd[7]},
    }


def erf_as(z: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz–Stegun 7.1.26 (max abs error 1.5e-7), the
    polynomial of the TPU kernel and of the Hopper kernels."""
    s = torch.sign(z)
    z = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-z * z))


def gelu_as(a: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU with :func:`erf_as`."""
    return a * 0.5 * (1.0 + erf_as(a * _SQRT_HALF))


def gelu_grad_as(a: torch.Tensor) -> torch.Tensor:
    """d gelu / da = Φ(a) + a·φ(a), Φ with :func:`erf_as`."""
    cdf = 0.5 * (1.0 + erf_as(a * _SQRT_HALF))
    pdf = torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
    return cdf + a * pdf


def _hidden(x2, w1, b1):
    """fp32 ``a = x·w1 + b1`` from operands rounded to x's dtype."""
    return x2.float() @ w1.to(x2.dtype).float() + b1.float()


def mlp_block_fwd_reference(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's arithmetic and its
    roundings only (module docstring)."""
    x2 = rows_view("mlp_block_fwd_reference", x)
    ga = gelu_as(_hidden(x2, w1, b1)).to(x.dtype)
    out = ga.float() @ w2.to(x.dtype).float() + b2.float()
    return out.to(x.dtype).view(x.shape)


def mlp_block_bwd_reference(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward, the TPU kernel's arithmetic step by step:
    ``(dx, dw1, db1, dw2, db2)``, dx in x's dtype, the others in their
    parameter's (``b2`` is read for its dtype only)."""
    x2 = rows_view("mlp_block_bwd_reference", x)
    dt = x.dtype
    gf = g.reshape(x2.shape).to(dt).float()
    w1c, w2c = w1.to(dt).float(), w2.to(dt).float()
    a = _hidden(x2, w1, b1)
    ga = gelu_as(a).to(dt).float()
    dga = gf @ w2c.t()
    da = (dga * gelu_grad_as(a)).to(dt).float()
    dx = da @ w1c.t()
    return (dx.to(dt).view(x.shape),
            (x2.float().t() @ da).to(w1.dtype), da.sum(0).to(b1.dtype),
            (ga.t() @ gf).to(w2.dtype), gf.sum(0).to(b2.dtype))


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library
    (``mlp_block_fwd`` or ``mlp_block_bwd``); idempotent."""
    return _build.load_library(name, _ARGTYPES[name])


def _check(fn: str, x2, w1, b1, w2, b2, g=None) -> Tuple[int, int, int]:
    """Raise ValueError for anything the kernels do not take; returns
    (N, D, H)."""
    if x2.dtype not in _DTYPES:
        raise ValueError(f"{fn}: x is {x2.dtype}; supported: bfloat16, "
                         "float32")
    N, D = x2.shape
    if w1.dim() != 2 or w1.shape[0] != D:
        raise ValueError(f"{fn}: w1 must be [D={D}, H], got "
                         f"{tuple(w1.shape)}")
    H = w1.shape[1]
    want = {"b1": (b1, (H,)), "w2": (w2, (H, D)), "b2": (b2, (D,))}
    if g is not None:
        want["g"] = (g, (N, D))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if D < 1 or H < 1:
        raise ValueError(f"{fn}: D={D}, H={H}: the kernels take D, H >= 1")
    named = {"x": x2, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    if g is not None:
        named["g"] = g
    for name, t in named.items():
        if t.dtype != (torch.float32 if name in ("b1", "b2") else x2.dtype):
            raise ValueError(f"{fn}: {name} is {t.dtype}; x, w1, w2 and g "
                             "must share x's dtype, b1 and b2 be float32 "
                             "(fused_mlp casts them)")
        if not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} is not contiguous (strides {t.stride()} for "
                f"shape {tuple(t.shape)}); the kernel never copies: make "
                "the layout copy explicit at the call")
    if not x2.is_cuda or any(t.device != x2.device for t in named.values()):
        raise ValueError(
            f"{fn}: {', '.join(named)} are on "
            f"{', '.join(str(t.device) for t in named.values())}; the "
            "kernel takes CUDA tensors of one device only")
    for name, t in named.items():
        if t.data_ptr() % 32:
            raise ValueError(f"{fn}: {name} starts at an address that is "
                             "not a multiple of 32 bytes (the tensor cores' "
                             "loads need it)")
    return N, D, H


def _pad_to(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """t zero-padded at the end of each dim to ``shape`` (t itself if it
    has that shape)."""
    if tuple(t.shape) == shape:
        return t
    pad = []
    for have, want in zip(reversed(t.shape), reversed(shape)):
        pad += [0, want - have]
    return torch.nn.functional.pad(t, pad)


def run_padded_fwd(launch, x2, w1, b1, w2, b2) -> torch.Tensor:
    """``launch(x2, w1, b1, w2, b2) -> out`` at the widths of
    :func:`padded_widths`: x's columns, w1 and w2 in both dims, b1 and b2
    zero-padded, the output's padded columns sliced off. The launchers run
    the kernel through it; the tests run the plain forward through it."""
    N, D = x2.shape
    H = w1.shape[1]
    Dp, Hp = padded_widths(D, H)
    if (Dp, Hp) == (D, H):
        return launch(x2, w1, b1, w2, b2)
    out = launch(_pad_to(x2, N, Dp), _pad_to(w1, Dp, Hp), _pad_to(b1, Hp),
                 _pad_to(w2, Hp, Dp), _pad_to(b2, Dp))
    return out[:, :D].contiguous()


def run_padded_bwd(launch, x2, w1, b1, w2, b2, g2) -> Tuple[torch.Tensor,
                                                             ...]:
    """``launch(x2, w1, b1, w2, b2, g2) -> (dx, dw1, db1, dw2, db2)`` at
    the padded widths, as :func:`run_padded_fwd` (g's columns padded like
    x's); the padded rows and columns of every gradient sliced off."""
    N, D = x2.shape
    H = w1.shape[1]
    Dp, Hp = padded_widths(D, H)
    if (Dp, Hp) == (D, H):
        return launch(x2, w1, b1, w2, b2, g2)
    dx, dw1, db1, dw2, db2 = launch(
        _pad_to(x2, N, Dp), _pad_to(w1, Dp, Hp), _pad_to(b1, Hp),
        _pad_to(w2, Hp, Dp), _pad_to(b2, Dp), _pad_to(g2, N, Dp))
    return (dx[:, :D].contiguous(), dw1[:D, :H].contiguous(),
            db1[:H].contiguous(), dw2[:H, :D].contiguous(),
            db2[:D].contiguous())


def mlp_block_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper forward kernel on PyTorch's current stream, at
    D and H padded to multiples of 16 (:func:`run_padded_fwd`): for bf16
    with D a multiple of 64 up to 768 the ``wgmma`` kernel; for bf16 with
    any other D the WMMA kernel, by the shape alone and never because the
    other failed; for fp32 the scalar kernel (:func:`launch_config` says
    which, and the tile, grid and column slices).
    ``w1`` and ``w2`` must already be in x's dtype and ``b1``, ``b2`` in
    fp32 (:func:`fused_mlp` casts them). Raises on anything the kernel does
    not take (non-CUDA tensors, other dtypes, tensors that are not
    contiguous, an empty width) and when the launch is refused; it copies only
    to pad a width and never falls back to the plain version.
    With grad mode on it raises for an input that requires grad:
    differentiate through :func:`fused_mlp`."""
    refuse_grad_inputs("mlp_block_fwd", "fused_mlp()", x, w1, b1, w2, b2)
    x2 = rows_view("mlp_block_fwd", x)
    _check("mlp_block_fwd", x2, w1, b1, w2, b2)
    return run_padded_fwd(_launch_fwd, x2, w1, b1, w2, b2).view(x.shape)


def _launch_fwd(x2, w1, b1, w2, b2) -> torch.Tensor:
    """One launch of the forward at widths that are multiples of 16."""
    N, D = x2.shape
    H = w1.shape[1]
    out = torch.empty((N, D), dtype=x2.dtype, device=x2.device)
    lib = load_library("mlp_block_fwd")
    with on_device(x2.device):
        rc = lib.pose3d_mlp_block_fwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), int(x2.dtype == torch.bfloat16),
            N, D, H, torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "mlp_block_fwd", rc)
    mlp_block_fwd.launches += 1
    return out


mlp_block_fwd.launches = 0


def mlp_block_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch the Hopper backward on PyTorch's current stream: kernels
    from one source, one over row tiles for dx, one over chunks of the
    hidden axis (times row groups on the ``wgmma`` path, whose fp32
    partials a small kernel adds in fixed order; the scratch for them is
    allocated here, at the size the library asks for) for dw1, db1, dw2
    and db2 (no
    atomics: a shape's gradients are the same from run to run). One call
    counts as one launch. Returns ``(dx`` in x's dtype, ``dw1, db1, dw2, db2`` in
    fp32``)``; operands as :func:`mlp_block_fwd`, ``g`` contiguous and of
    x's dtype and shape (``b2`` is checked, not read)."""
    refuse_grad_inputs("mlp_block_bwd", "fused_mlp()", x, w1, b1, w2, b2, g)
    x2 = rows_view("mlp_block_bwd", x)
    if g.shape != x.shape:
        raise ValueError(f"mlp_block_bwd: g must have x's shape "
                         f"{tuple(x.shape)}, got {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError(f"mlp_block_bwd: g is not contiguous (strides "
                         f"{g.stride()}); the kernel never copies")
    _check("mlp_block_bwd", x2, w1, b1, w2, b2, g.view(x2.shape))
    dx, dw1, db1, dw2, db2 = run_padded_bwd(_launch_bwd, x2, w1, b1, w2, b2,
                                            g.view(x2.shape))
    return dx.view(x.shape), dw1, db1, dw2, db2


def _launch_bwd(x2, w1, b1, w2, b2, g2) -> Tuple[torch.Tensor, ...]:
    """One backward (one launch counted) at widths that are multiples of
    16."""
    N, D = x2.shape
    H = w1.shape[1]
    f32 = torch.float32
    dx = torch.empty((N, D), dtype=x2.dtype, device=x2.device)
    dw1 = torch.empty((D, H), dtype=f32, device=x2.device)
    dw2 = torch.empty((H, D), dtype=f32, device=x2.device)
    db1 = torch.empty((H,), dtype=f32, device=x2.device)
    db2 = torch.empty((D,), dtype=f32, device=x2.device)
    lib = load_library("mlp_block_bwd")
    is_bf16 = int(x2.dtype == torch.bfloat16)
    # the scratch's size from the library that will check it
    n_scratch = _bwd_config(lib, is_bf16, N, D, H)[8]
    scratch = torch.empty((n_scratch,), dtype=f32, device=x2.device)
    with on_device(x2.device):
        rc = lib.pose3d_mlp_block_bwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            g2.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr(), n_scratch,
            is_bf16, N, D, H,
            torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "mlp_block_bwd", rc)
    mlp_block_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


mlp_block_bwd.launches = 0


class FusedMlp(torch.autograd.Function):
    """``FusedMlp.apply(x, w1, b1, w2, b2, use_kernel)`` → out.
    ``use_kernel`` picks the Hopper pair (CUDA tensors only), otherwise the
    plain pair runs, forward and backward. The weights are cast to x's
    dtype and the biases to fp32 here, outside the kernels; every gradient
    comes back in its parameter's own dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, use_kernel: bool):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.use_kernel = use_kernel
        with torch.no_grad():
            if use_kernel:
                return mlp_block_fwd(x, w1.to(x.dtype), b1.float(),
                                     w2.to(x.dtype), b2.float())
            return mlp_block_fwd_reference(x, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        # autograd hands g over in whatever layout the next op produced
        g = g.contiguous()
        if ctx.use_kernel:
            dx, dw1, db1, dw2, db2 = mlp_block_bwd(
                x, w1.to(x.dtype), b1.float(), w2.to(x.dtype), b2.float(), g)
            grads = (dx, dw1.to(w1.dtype), db1.to(b1.dtype),
                     dw2.to(w2.dtype), db2.to(b2.dtype))
        else:
            grads = mlp_block_bwd_reference(x, w1, b1, w2, b2, g)
        return (*grads, None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """``gelu_exact(x @ w1 + b1) @ w2 + b2`` over the last axis of ``x``
    (any leading shape), output in x's dtype; differentiable in all five.

    ``impl="auto"``: the kernels for a CUDA tensor (they raise rather than
    degrade to the plain version), the plain pair for a CPU tensor.
    ``impl="reference"`` forces the plain pair on any device (the on-card
    comparisons)."""
    if impl not in IMPLS:
        raise ValueError(f"fused_mlp impl {impl!r} not in {IMPLS}")
    use_kernel = impl == "auto" and x.device.type != "cpu"
    return FusedMlp.apply(x, w1, b1, w2, b2, use_kernel)


def mlp_params(source) -> Tuple[torch.Tensor, ...]:
    """``(w1 [D, H], b1, w2 [H, D], b2)`` for :func:`fused_mlp`,
    contiguous, from the port's ``Mlp`` module (two ``nn.Linear``s under
    the keys in ``source.names``, ``("fc1", "fc2")`` or ``("0", "3")``,
    weights ``[out, in]``: transposed copies) or from a flax ``Mlp``'s
    parameters (a mapping ``Dense_0``/``Dense_1`` → ``kernel`` ``[in,
    out]``, ``bias``, numpy leaves: copied as they lie)."""
    if isinstance(source, torch.nn.Module):
        fc1, fc2 = (getattr(source, n) for n in source.names)
        return (fc1.weight.t().contiguous(), fc1.bias,
                fc2.weight.t().contiguous(), fc2.bias)
    return tuple(torch.from_numpy(np.array(source[d][k], copy=True))
                 for d in ("Dense_0", "Dense_1") for k in ("kernel", "bias"))
