"""What the launchers share around a launch: the ``[rows, C]`` view that
never copies, the refusal of inputs whose gradient a raw kernel would drop,
the device context, and, for the kernels that add partial rows across
blocks in the same launch (``bn_stats``, ``layer_norm`` backward:
``csrc/row_reduce.cuh``), the counters of the barrier before that
combine."""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

# the card's SMs (H100 SXM): the grids of the two kernels are sized to them
SMS = 132


def rows_view(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[..., C]`` as a ``[rows, C]`` view. Never copies: a tensor
    whose leading axes do not flatten, or whose last axis is not
    contiguous, is refused."""
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: need a non-empty [..., C] tensor, got "
                         f"shape {tuple(x.shape)}")
    C = x.shape[-1]
    if C > 1 and x.stride(-1) != 1:
        raise ValueError(
            f"{name}: the last axis must be contiguous; got strides "
            f"{x.stride()} for shape {tuple(x.shape)} (make the layout copy "
            "explicit at the call)")
    if x.dim() == 2:
        return x
    try:
        return x.view(-1, C)
    except RuntimeError:
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} with strides {x.stride()} does "
            "not flatten to [rows, C] without a copy (make the copy explicit "
            "at the call)") from None


def refuse_grad_inputs(fn: str, instead: str, *tensors) -> None:
    """A raw launcher's outputs carry no autograd graph: with grad mode on,
    raise for an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn}: an input requires grad, and the raw kernel would drop "
            f"its gradient; differentiate through {instead}")


def on_device(dev: torch.device):
    """The context a launch runs in: none when ``dev`` is the current
    device (entering one costs tens of microseconds per launch)."""
    return (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def stream_counters(device: torch.device, n: int) -> torch.Tensor:
    """The zeroed int32 barrier counters of the combine for kernels
    launched on ``device``'s current stream, at least ``n`` of them. One
    buffer per device and stream, made (zeroed, on that stream) at first
    use or when a call needs more; a kernel leaves every counter it used at
    0 again. Calls on one stream run one after the other, calls on two
    streams take two buffers, so no two running kernels share a
    counter."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
