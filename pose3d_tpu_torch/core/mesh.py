"""Process meshes over ``torch.distributed`` (counterpart of
``pose3d_tpu/core/mesh.py``).

One process drives one card (``cuda:<local rank>``), so where the JAX
package arranges devices the port arranges ranks: a :class:`Mesh` is an
integer array of global ranks with named axes. The primary axis is
``data`` (the batch shards over it and the gradients are averaged across
it); ``model`` carries tensor and sequence parallelism, ``stage`` pipeline
stages, and ``replica`` the outer axis of a hybrid mesh. Each rank owns one
process group per set of axes it is asked for, made when the mesh is built
(every rank builds its meshes in the same order, as ``new_group`` needs).

``--batch-size`` is per process, as in the JAX package's multi-process
mode: the global batch is the per-process batch times the batch axes' size.
Each process feeds its own rows; :func:`shard_batch` takes this rank's rows
of a batch that every rank holds.

Backend: NCCL for a CUDA device and gloo for ``device="cpu"``, unless the
caller names one. A missing or refusing NCCL is an error, never a quiet
switch to gloo.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import socket
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pose3d_tpu_torch.core.comm import all_reduce_, chunk_sizes

logger = logging.getLogger("pose3d_tpu_torch.mesh")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU; NCCL must be there."""
    if torch.device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("device cuda needs the NCCL backend, which "
                               "this PyTorch lacks (name a backend to use "
                               "another)")
        return "nccl"
    return "gloo"


def local_device(device="cuda") -> torch.device:
    """This process's card: ``cuda:<local rank>`` (``LOCAL_RANK``, else the
    global rank modulo the visible cards); the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass device='cpu')")
    local = int(os.environ.get("LOCAL_RANK", _rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group: ``init_process_group`` at
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks as rank
    ``process_id``. A no-op (returns False) when all three are None, as a
    one-process job; a partial set raises."""
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        return False
    if any(a is None for a in args):
        raise ValueError("--coordinator, --num-processes and --process-id "
                         "go together")
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda":
        os.environ.setdefault("LOCAL_RANK", str(
            int(process_id) % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    logger.info("Process %d of %d joined %s at %s", process_id,
                num_processes, backend, coordinator_address)
    return True


def host_shard_info() -> tuple:
    """(shard_id, num_shards) for host-side data sharding: the rank and
    the world size."""
    return _rank(), _world()


def warmup_collectives(device=None) -> float:
    """One tiny all-reduce over every rank right after the process group
    is up (a world of one included); returns its result, the world size:
    a cheap check of the cluster, and a fast failure on a misconfigured
    one. 1.0 without a process group."""
    if not dist.is_initialized():
        return 1.0
    if device is None:
        device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.ones(1, device=local_device(device))
    all_reduce_(t, dist.group.WORLD)
    return float(t.item())


class Mesh:
    """Global ranks in a named grid (the port's ``jax.sharding.Mesh``):
    ``devices`` is the rank array, ``shape`` maps axis → size.

    :meth:`group` returns this rank's process group over a set of axes
    (None when that set spans one rank or no process group is up), made
    for every set of axes when the mesh is built in a multi-process
    job."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D ranks for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.size = int(self.devices.size)
        self._groups: Dict[tuple, object] = {}
        if _world() > 1:
            self._make_groups()

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, ranks="
                f"{self.devices.tolist()})")

    def _make_groups(self) -> None:
        me = _rank()
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(self.devices.ndim)
                        if i not in keep]
                grid = np.transpose(self.devices, rest + keep).reshape(
                    -1, int(np.prod([self.devices.shape[i] for i in keep])))
                for ranks in grid:
                    ranks = sorted(int(r) for r in ranks)
                    if len(ranks) == 1:
                        continue
                    g = dist.new_group(ranks)
                    if me in ranks:
                        self._groups[axes] = g

    def _axes(self, axes) -> tuple:
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """This rank's process group over ``axes`` (a name or names), or
        None when they span a single rank."""
        axes = self._axes(axes)
        if self.axis_size(axes) == 1 or _world() == 1:
            return None
        if axes not in self._groups:
            raise ValueError(f"rank {_rank()} is not in {self}")
        return self._groups[axes]

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis → index of ``rank`` (default: this process)."""
        rank = _rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` taken jointly (row-major)."""
        axes = self._axes(axes)
        c = self.coords()
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of ``devices`` (default: every rank). ``shape`` may hold one
    ``-1``, which takes the remaining ranks (as a reshape)."""
    devices = list(range(_world())) if devices is None else list(devices)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) \
            if len(shape) > 1 else 1
        shape[shape.index(-1)] = len(devices) // known
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(shape), axes)


def make_data_mesh_for_batch(batch_size: int,
                             devices: Optional[Sequence[int]] = None
                             ) -> Mesh:
    """1-D data mesh whose size divides ``batch_size`` (the largest such
    rank count); logs when ranks go unused."""
    devices = list(range(_world())) if devices is None else list(devices)
    n = len(devices)
    d = math.gcd(batch_size, n)
    while n % d and d > 1:
        d -= 1
    if d < n:
        logger.warning("batch %d not divisible by %d devices; using "
                       "%d-device data mesh", batch_size, n, d)
    return make_mesh((d,), ("data",), devices=devices[:d])


def _node_key():
    """Rank → node index (first appearance of each host name)."""
    if _world() == 1:
        return lambda r: 0
    names = [None] * _world()
    dist.all_gather_object(names, socket.gethostname())
    index = {h: i for i, h in enumerate(dict.fromkeys(names))}
    return lambda r: index[names[r]]


def make_hybrid_mesh(
    ici_shape: Sequence[int] = (-1,),
    ici_axes: Sequence[str] = ("data",),
    dcn_axis: str = "replica",
    devices: Optional[Sequence[int]] = None,
    slice_key=None,
) -> Mesh:
    """Two-tier mesh: the leading ``dcn_axis`` enumerates groups of ranks
    (default: one per node, from the host names; ``slice_key(rank)``
    chooses another grouping), the inner ``ici_axes`` span each group.
    Batch-sharded work runs over both tiers; parameter collectives stay in
    a group. All groups must be the same size; one group gives a
    ``(1, *ici_shape)`` mesh."""
    devices = list(range(_world())) if devices is None else list(devices)
    if slice_key is None:
        slice_key = _node_key()
    groups: dict = {}
    for d in devices:
        groups.setdefault(slice_key(d), []).append(d)
    sizes = {len(g) for g in groups.values()}
    if len(sizes) != 1:
        raise ValueError(
            "slices are unequal (devices per slice): "
            f"{ {k: len(v) for k, v in groups.items()} }")
    per_slice = sizes.pop()
    ici_shape = list(ici_shape)
    if -1 in ici_shape:
        known = int(np.prod([s for s in ici_shape if s != -1]))
        ici_shape[ici_shape.index(-1)] = per_slice // max(known, 1)
    if int(np.prod(ici_shape)) != per_slice:
        raise ValueError(f"ici_shape {ici_shape} does not cover the "
                         f"{per_slice} devices of each slice")
    ordered = [sorted(groups[k]) for k in sorted(groups)]
    return Mesh(np.array(ordered).reshape([len(ordered)] + ici_shape),
                (dcn_axis, *tuple(ici_axes)))


def batch_axes(mesh: Mesh) -> tuple:
    """The axes the batch shards over: ``data`` plus, on a hybrid mesh,
    ``replica``."""
    return tuple(a for a in ("replica", "data") if a in mesh.axis_names)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.axis_size(batch_axes(mesh))
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"batch axes size {n}")
    return global_batch // n


def batch_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of an ``n``-row batch: its shard along the batch
    axes (``tensor_split`` shards, so a ragged batch splits unevenly)."""
    k = mesh.axis_size(batch_axes(mesh))
    i = mesh.axis_index(batch_axes(mesh)) if k > 1 else 0
    sizes = chunk_sizes(n, k)
    start = sum(sizes[:i])
    return slice(start, start + sizes[i])


def shard_batch(mesh: Mesh, batch: Dict, batch_axis: int = 0) -> Dict:
    """This rank's rows of every array of ``batch`` along ``batch_axis``
    (1 for a ``[A, B, ...]`` superbatch); keys starting with "_" are host
    metadata and pass through. Where the JAX function places a global
    batch on the mesh, each rank here keeps its own part of it."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            out[k] = v
            continue
        rows = batch_rows(v.shape[batch_axis], mesh)
        idx = (slice(None),) * batch_axis + (rows,)
        out[k] = v[idx]
    return out
