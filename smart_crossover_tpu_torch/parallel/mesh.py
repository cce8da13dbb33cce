"""Device mesh for the sharded pipelines: one process per rank.

Port of ``smart_crossover_tpu/parallel/mesh.py``.  The framework's two
scaling axes map onto a 2-D mesh of ranks:

* ``batch``  — data parallelism over OT/MCF/LP instances;
* ``model`` — intra-instance parallelism: columns of the OT cost/plan
  matrices, LP column blocks, arcs, and the projector's CG reductions.

The JAX package's sharded functions are single-controller: one process
holds the whole mesh and ``shard_map`` with ``psum``/``pmax``/``pmin`` does
the rest.  PyTorch is SPMD, one process per rank, and the port's rule is:

* every rank calls a sharded function with the same arguments as the JAX
  signature, the full host arrays included;
* each rank takes its own slice along the axis the function shards
  (``Mesh.slice``) and runs its shard; the collectives of ``Mesh`` over
  that axis's process group stand for ``psum``/``pmax``/``pmin``;
* each rank returns the gathered full result (``Mesh.gather``): numpy
  where the JAX function returns numpy, a tensor on the rank's device
  where it returns a global ``Array``.

Every loop whose condition is a collective in JAX branches here on a
reduced value that all ranks read alike, so no rank leaves a loop alone.

At world size 1 no launcher is needed: ``make_mesh()`` starts a one-rank
group on a ``HashStore``.  For p ranks start p processes with ``torchrun
--nproc-per-node p`` (``env://``), or call ``init_distributed(
init_method="tcp://host:port", world_size=p, rank=i)`` in each; on a card
the collectives run on NCCL (CPU tensors on gloo), with ``device="cpu"``
on gloo alone.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from smart_crossover_tpu_torch.config import resolve_device

BATCH_AXIS = "batch"
MODEL_AXIS = "model"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def init_distributed(**kwargs) -> None:
    """Start the default process group; a no-op once it is initialised.

    Takes ``torch.distributed.init_process_group``'s keywords, the JAX
    package's names for them (``coordinator_address`` = "host:port",
    ``num_processes``, ``process_id``) and ``device`` (the card unless
    "cpu" is asked for).  The backend is NCCL for CUDA tensors with gloo
    for CPU tensors on a card, gloo alone on the CPU.  With no
    ``init_method`` or ``store`` and no ``WORLD_SIZE`` in the environment
    the group has one rank, on a ``HashStore``."""
    if dist.is_initialized():
        return
    device = kwargs.pop("device", None)
    coordinator = kwargs.pop("coordinator_address", None)
    if coordinator is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator}")
    if "num_processes" in kwargs:
        kwargs.setdefault("world_size", kwargs.pop("num_processes"))
    if "process_id" in kwargs:
        kwargs.setdefault("rank", kwargs.pop("process_id"))
    dev = resolve_device(device)
    kwargs.setdefault("backend", "cpu:gloo,cuda:nccl" if dev.type == "cuda"
                      else "gloo")
    if ("init_method" not in kwargs and "store" not in kwargs
            and "WORLD_SIZE" not in os.environ):
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        rank = int(kwargs.get("rank", os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


class Mesh:
    """A (batch, model) ``DeviceMesh`` of ranks and the collectives along
    its axes.  ``dict(mesh.shape)`` is ``{"batch": n_batch, "model":
    n_model}`` as for a JAX mesh; ``device`` is this rank's device."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(device_mesh.mesh_dim_names,
                              device_mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.device_mesh.get_local_rank(axis)

    def slice(self, axis: str, length: int) -> tuple[int, int]:
        """[lo, hi) of this rank's block of ``length`` entries split
        evenly along ``axis`` (the JAX ``PartitionSpec(axis)``)."""
        p = self.size(axis)
        if length % p:
            raise ValueError(f"the mesh's {axis!r} width {p} does not "
                             f"divide {length}")
        k = length // p
        i = self.index(axis)
        return i * k, (i + 1) * k

    def all_reduce(self, t: torch.Tensor, op: str,
                   axis: str = MODEL_AXIS) -> torch.Tensor:
        """The reduction of ``t`` over ``axis`` (``psum``, ``pmax``,
        ``pmin`` for op "sum", "max", "min"), a new tensor on every rank.
        NCCL has no MIN/MAX on bool, so bools go through int32."""
        out = t.to(torch.int32) if t.dtype == torch.bool else t.clone()
        dist.all_reduce(out, _OPS[op], group=self.device_mesh.get_group(axis))
        return out.bool() if t.dtype == torch.bool else out

    def sum(self, t, axis: str = MODEL_AXIS):
        return self.all_reduce(t, "sum", axis)

    def max(self, t, axis: str = MODEL_AXIS):
        return self.all_reduce(t, "max", axis)

    def min(self, t, axis: str = MODEL_AXIS):
        return self.all_reduce(t, "min", axis)

    def gather(self, t: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
        """The blocks of every rank along ``axis`` concatenated in axis
        order along ``dim``: the full tensor from each rank's slice."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(parts, src, group=self.device_mesh.get_group(axis))
        out = torch.cat(parts, dim)
        return out.bool() if t.dtype == torch.bool else out


def make_mesh(n_batch: int | None = None, n_model: int = 1, devices=None,
              *, device=None) -> Mesh:
    """Build a (batch, model) mesh over the ranks of the default group.

    ``devices``: the global ranks in mesh order (default: all ranks in
    rank order); it must name every rank.  ``n_batch`` defaults to the
    rank count over ``n_model``.  ``device``: the card unless "cpu" is
    asked for.  Without a process group and without ``WORLD_SIZE`` set
    this starts a one-rank group (``init_distributed``)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    init_distributed(device=dev)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices must name each of the {world} ranks "
                         f"once, got {ranks}")
    n = len(ranks)
    if n_batch is None:
        n_batch = n // n_model
    if n_batch * n_model != n:
        raise ValueError(
            f"mesh {n_batch}x{n_model} does not match {n} devices")
    dm = DeviceMesh(dev.type, torch.tensor(ranks).reshape(n_batch, n_model),
                    mesh_dim_names=(BATCH_AXIS, MODEL_AXIS))
    if dev.type == "cuda" and dev.index is None:
        # this rank's card, as init_distributed set it
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dm, dev)

