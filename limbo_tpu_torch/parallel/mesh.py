"""Process groups, device meshes and the collectives of the distribution
layer (port of limbo_tpu/parallel/mesh.py).

The reference's ``jax.sharding.Mesh`` plus ``shard_map`` (a global array in,
sharded by spec) becomes SPMD over a ``torch.distributed`` process group,
one process per card:

* every rank runs the same program on the same replicated inputs and
  slices its own rows (``row0 = rank * rows_loc``), so replicated results
  come out identical on every rank;
* sharded state (a row block of the Cholesky factor, a column panel of
  K^{-1}) is held as the rank's local block plus its geometry;
* the collectives are the two wrappers below, ``psum`` (``dist.all_reduce``)
  and ``all_gather`` (tiled, ``dist.all_gather_single``), which the
  collective audit (parallel/comm_audit.py) counts; ``jax.lax.axis_index``
  becomes ``Axis.rank``, the rank in the axis's group.

DTensor is not used: its dispatch would hide the communication the audit
must count.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dimensions (``init_device_mesh``), built over an initialized default
group: NCCL on the card, gloo for CPU tensors.  ``start_group`` starts one
from a ``FileStore`` in a temporary directory (no TCP port);
parallel/multihost.py joins hosts over TCP.

Axis naming convention, as the reference's:
  "restarts" - acquisition restart / candidate fan-out (data-parallel);
  "rows"     - kernel-matrix row sharding for large-n regression;
  "cols"     - K^{-1} column panels (parallel/sharded_acq.py).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from limbo_tpu_torch.parallel import comm_audit
from limbo_tpu_torch.utils.device import resolve_device


def backend_for(device) -> str:
    """The collective backend for tensors on `device`: NCCL for the card,
    gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_cuda_device(rank: int) -> torch.device:
    """The card of a rank: LOCAL_RANK (torchrun, SLURM launchers) or the
    rank, modulo the cards this host has."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


class Group:
    """The default process group, started from a ``FileStore``.

    ``Group(world_size, rank, device, store_dir)``: every rank of the group
    passes the same ``store_dir`` (one rank alone may leave it None: a
    temporary directory is made and removed by ``close``).  ``device``
    (default "cuda", which raises without a card) picks the backend: NCCL
    for the card, gloo for the CPU.  Use it as a context manager, or call
    ``close``, so that no group outlives its user."""

    def __init__(self, world_size: int = 1, rank: int = 0, device="cuda",
                 store_dir: Optional[str] = None):
        dev = resolve_device(device)
        if dist.is_initialized():
            raise RuntimeError("a default process group is already "
                               "initialized")
        self._tmp = None
        if store_dir is None:
            if world_size != 1:
                raise ValueError("the ranks of a group share one store_dir")
            self._tmp = tempfile.TemporaryDirectory(prefix="limbo_pg_")
            store_dir = self._tmp.name
        if dev.type == "cuda":
            dev = local_cuda_device(rank)
            torch.cuda.set_device(dev)
        self.device = dev
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
        try:
            dist.init_process_group(backend_for(dev), store=store, rank=rank,
                                    world_size=world_size)
        except BaseException:
            self._cleanup()
            raise

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        self._cleanup()

    def _cleanup(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self) -> "Group":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_group(world_size: int = 1, rank: int = 0, device="cuda",
                store_dir: Optional[str] = None) -> Group:
    """Initialize the default process group from a FileStore (see Group)."""
    return Group(world_size, rank, device, store_dir)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "restarts"):
    """1-D mesh over the group's ranks (one card, or one CPU process, a
    rank); ``n_devices`` must be the world size when given."""
    world = dist.get_world_size()
    n = n_devices if n_devices is not None else world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a group of {n}; the "
                         f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (n,),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(n_restarts: int, n_rows: int):
    """(restarts, rows) mesh over n_restarts * n_rows ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (n_restarts, n_rows),
                            mesh_dim_names=("restarts", "rows"))


def mesh_device(mesh) -> torch.device:
    """The device a mesh's tensors live on: this rank's card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclass(frozen=True)
class Axis:
    """One named mesh dimension as seen by this rank: its process group,
    this rank's index in it (the reference's ``jax.lax.axis_index``) and
    its size."""

    name: str
    group: object
    rank: int
    size: int


def mesh_axis(mesh, axis=None) -> Axis:
    """The Axis of `axis` (a name, default the mesh's first dimension; an
    Axis is returned as it is)."""
    if isinstance(axis, Axis):
        return axis
    name = axis if axis is not None else mesh.mesh_dim_names[0]
    if name not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {name!r} (its axes: "
                         f"{mesh.mesh_dim_names})")
    dim = mesh.mesh_dim_names.index(name)
    return Axis(name=name, group=mesh.get_group(name),
                rank=mesh.get_local_rank(name), size=mesh.size(dim))


def shard_batch(mesh, axis: str = "restarts") -> Callable:
    """Placement of a leading batch axis: a function that returns this
    rank's block of the rows of a replicated (P, ...) tensor."""
    ax = mesh_axis(mesh, axis)

    def place(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % ax.size:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh "
                             f"axis '{ax.name}' size {ax.size}")
        n = x.shape[0] // ax.size
        return x[ax.rank * n:(ax.rank + 1) * n]

    return place


def replicated(mesh) -> Callable:
    """Placement of a replicated value: every rank keeps all of it."""
    return lambda x: x


# ---------------------------------------------------------------------------
# the collectives (counted by parallel/comm_audit.py)
# ---------------------------------------------------------------------------

def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum of x over the axis's ranks (``jax.lax.psum``), every rank
    receiving it: ``dist.all_reduce``, in place on x when it is contiguous
    (pass a tensor you own).  Not differentiable."""
    x = x.contiguous()
    comm_audit.record("psum", x)
    dist.all_reduce(x, group=ax.group)
    return x


def all_gather(x: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of x concatenated along `dim` in rank order
    (``jax.lax.all_gather(..., tiled=True)``).  The collective gathers
    along dim 0, so another dim is moved to the front and back."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((ax.size * xt.shape[0], *xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    comm_audit.record("all_gather", out)
    # all_gather_single where torch has it (2.13, which deprecates
    # all_gather_into_tensor); torch 2.11 has only all_gather_into_tensor,
    # the same dim-0 gather
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    gather(out, xt, group=ax.group)
    return out.movedim(0, dim)
