"""Device mesh and sharding rules over ``torch.distributed`` — explicit SPMD.

PyTorch port of ``morl_baselines_tpu/parallel/mesh.py``.  MORL workloads
have tiny networks, so the parallel axes that matter are

- ``data``: the vectorized env batch (thousands of envs per card), and
- ``pop``: population members / weight vectors (MORL/D's vectorized mode).

The semantics are the JAX package's:

- params (and their optimizers) are replicated: every rank holds them whole;
- the env batch is sharded over ``data`` (a population over ``pop``): rank r
  of W holds the contiguous rows ``[r·N/W, (r+1)·N/W)`` of every per-env
  tensor;
- the replay buffer stays replicated: every ``add_batch`` all-gathers the
  per-rank transitions (packed into one byte tensor, so one collective a
  step), so each replica holds the full ring;
- every replica samples the same batch, so a data-sharded run equals the
  one-process run.

Where the JAX package annotates shardings and lets XLA insert the
collectives, the port is one program per rank: a state carries a
``RowShard`` (rank, world size, process group) in its ``shard`` field, and
the agents call ``local`` and ``gather_rows`` at the few places where a
per-env tensor meets a replicated one.

Random streams: every rank holds the same generator state.  At each per-env
draw a rank draws the full N (or P) rows and keeps its own slice through
``local``, which is the identity for a state without a shard, so the draws
are the one-process stream.  Batch sampling, the update's weight draws and
the target updates draw the same on every rank, unsliced.  Every rank then
updates the same replicated params from the same batch, so no gradient
all-reduce is needed and the replicas stay bitwise equal
(``assert_replicas_synced``).

A ``DeviceMesh`` over NCCL (``device="cuda"``, one card per rank) or gloo
(``device="cpu"``) describes the layout; ``launch`` starts the ranks.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor.placement_types import Replicate, Shard

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(
    n_devices: int | None = None,
    axis_names: Sequence[str] = ("data",),
    shape: Sequence[int] | None = None,
    device="cuda",
) -> DeviceMesh:
    """A mesh over the ranks of the initialised process group: 1-D over
    ``data`` with one axis name, or ``axis_names=("pop", "data")`` with
    ``shape=(p, d)``.  ``n_devices`` (default: all ranks) must be the world
    size; ``device`` is ``"cuda"`` (the group's backend must be NCCL) or
    ``"cpu"`` (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see launch)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices={n} is not the world size {world}")
    device_type = torch.device(device).type
    backend = dist.get_backend()
    if _BACKENDS.get(device_type) != backend:
        raise ValueError(f"a {device_type} mesh needs the {_BACKENDS.get(device_type)} backend, the group has {backend}")
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if math.prod(shape) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} over {tuple(axis_names)} does not fit {n} ranks")
    return init_device_mesh(device_type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axis_names))


def replicated(mesh: DeviceMesh) -> list:
    """Placements of a tensor every rank holds whole."""
    return [Replicate()] * mesh.ndim


def batch_sharded(mesh: DeviceMesh, axis: str = "data") -> list:
    """Placements of a tensor whose leading dim is split over ``axis`` and
    replicated over the other mesh axes."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, not {axis!r}")
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rank ``rank`` of ``world`` over ``group`` holds rows ``[rank·n/world,
    (rank+1)·n/world)`` of every sharded tensor of n rows."""

    rank: int
    world: int
    group: Any

    def span(self, n: int) -> tuple[int, int]:
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        k = n // self.world
        return self.rank * k, k

    def local(self, x, dim: int = 0):
        """This rank's rows of a tensor, a tree of them, or a sequence of per-row items."""
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            start, k = self.span(x.shape[dim])
            return x.narrow(dim, start, k)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(self.local(v, dim) for v in x))
        if isinstance(x, tuple) and x and isinstance(x[0], (torch.Tensor, tuple)):
            return tuple(self.local(v, dim) for v in x)
        start, k = self.span(len(x))
        return x[start : start + k]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All ranks' rows of ``x`` (leading dim), rank-major: the full tensor."""
        x = x.contiguous()
        if dist.get_backend(self.group) == "nccl":
            out = torch.empty((self.world * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=self.group)
            return out
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=0)

    def gather_rows(self, tree):
        """``gather`` of every tensor of a NamedTuple or tuple (same leading
        dim), packed as bytes into one tensor: one collective for the lot,
        exact for every dtype."""
        leaves = list(tree)
        n = leaves[0].shape[0]
        flat = [x.contiguous().reshape(n, -1).view(torch.uint8) for x in leaves]
        widths = [f.shape[1] for f in flat]
        full = self.gather(torch.cat(flat, dim=1))
        out, at = [], 0
        for x, w in zip(leaves, widths):
            out.append(full[:, at : at + w].contiguous().view(x.dtype).reshape(full.shape[0], *x.shape[1:]))
            at += w
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)

    def all(self, flag: torch.Tensor) -> bool:
        """Whether ``flag.all()`` holds on every rank (one all-reduce)."""
        v = flag.all().to(torch.int32).reshape(1)
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self.group)
        return bool(v.item())


def local(shard: RowShard | None, x, dim: int = 0):
    """``shard.local(x, dim)``; ``x`` itself without a shard."""
    return x if shard is None else shard.local(x, dim)


def gather_rows(shard: RowShard | None, tree):
    """``shard.gather_rows(tree)``; ``tree`` itself without a shard."""
    return tree if shard is None else shard.gather_rows(tree)


def gather(shard: RowShard | None, x: torch.Tensor) -> torch.Tensor:
    """``shard.gather(x)``; ``x`` itself without a shard."""
    return x if shard is None else shard.gather(x)


def global_rows(shard: RowShard | None, n: int) -> int:
    """The full row count of a sharded axis whose local count is ``n``."""
    return n if shard is None else n * shard.world


def mesh_shard(mesh: DeviceMesh, axis: str | None = None) -> RowShard:
    """The ``RowShard`` of this rank for a tensor placed ``batch_sharded(mesh,
    axis)`` (default: the mesh's first axis): its rows split over the ranks
    of the mesh dim that shards them."""
    placements = batch_sharded(mesh, mesh.mesh_dim_names[0] if axis is None else axis)
    mesh_dim = next(i for i, p in enumerate(placements) if isinstance(p, Shard))
    group = mesh.get_group(mesh_dim)
    return RowShard(dist.get_rank(group), dist.get_world_size(group), group)


def shard_agent_state(state, mesh: DeviceMesh, batched_fields: set[str], axis: str = "data"):
    """The state with every leaf of the ``batched_fields`` cut to this rank's
    rows over ``axis`` and the ``RowShard`` in its ``shard`` field; the other
    fields (params, optimizers, buffers, generators) stay replicated.
    Field names the state lacks are ignored, as in the JAX package.  Raises
    ``ValueError`` when a batched leaf's rows do not split over the ranks."""
    if not dataclasses.is_dataclass(state) or "shard" not in {f.name for f in dataclasses.fields(state)}:
        raise ValueError(f"{type(state).__name__} has no shard field")
    shard = mesh_shard(mesh, axis)
    cut = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
    changes = {}
    for f in dataclasses.fields(state):
        if f.name in batched_fields:
            changes[f.name] = _tree_map(cut, shard.local(getattr(state, f.name)))
    return dataclasses.replace(state, shard=shard, **changes)


def _tree_map(fn, x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, tuple):
        return tuple(_tree_map(fn, v) for v in x)
    return fn(x)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8) if t.is_floating_point() else t.reshape(-1)


@torch.no_grad()
def assert_replicas_synced(module_or_params, group=None) -> None:
    """Raise ``AssertionError`` unless every rank of ``group`` holds bitwise
    the same params (a module's parameters and buffers, or a list of tensors):
    each is all-gathered and compared bit for bit (the JAX package's
    ``__graft_entry__._assert_replicas_synced``)."""
    if isinstance(module_or_params, torch.nn.Module):
        named = list(module_or_params.state_dict().items())
    else:
        named = [(str(i), t) for i, t in enumerate(module_or_params)]
    world = dist.get_world_size(group)
    for name, t in named:
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        if not all(torch.equal(_bits(p), _bits(parts[0])) for p in parts[1:]):
            raise AssertionError(f"param {name} differs across the {world} replicas")


def _rank_entry(rank: int, fn: Callable, world: int, init_method: str, backend: str, args: tuple) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, init_method: str, backend: str = "gloo", args: tuple = ()) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes started
    by ``torch.multiprocessing.spawn``, each in a process group of ``backend``
    (gloo on the CPU, NCCL with one card a rank) joined through
    ``init_method`` (``"file://<path>"``, a path no other run uses).  ``fn``
    must be a module-level function.  Raises if a rank fails."""
    if init_method.startswith("file://"):
        path = init_method[len("file://") :]
        if os.path.exists(path):
            os.remove(path)
    mp.spawn(_rank_entry, args=(fn, world_size, init_method, backend, args), nprocs=world_size, join=True)
