"""Multi-host execution: process-group bring-up and cross-host meshes (port
of limbo_tpu/parallel/multihost.py).

The reference's only multi-node story upstream is communication-free
cluster replication (waf_tools/limbo.py:169-357 writes per-replicate job
scripts); the JAX package brings up ``jax.distributed`` instead.  Here every
process (one per card) calls ``initialize``, which joins the default
``torch.distributed`` group over TCP (NCCL on the cards, gloo on the CPU),
after which a mesh spans every rank of every host.

Bring-up resolves coordinates in this order:
  1. explicit arguments (``coordinator_address`` "host:port");
  2. the SLURM environment (SLURM_JOB_NODELIST / SLURM_PROCID /
     SLURM_NTASKS, what experiment/launcher.py's sbatch scripts provide):
     ``init_process_group(init_method=f"tcp://{head}:{port}",
     world_size=SLURM_NTASKS, rank=SLURM_PROCID)``;
  3. a single process: nothing is started.

Under ``torchrun`` the coordinates come from its environment: pass
``coordinator_address=f"{MASTER_ADDR}:{MASTER_PORT}"``,
``num_processes=WORLD_SIZE`` and ``process_id=RANK``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from limbo_tpu_torch.parallel.mesh import backend_for, local_cuda_device


class _State:
    """Whether this module started the default group (so shutdown ends
    only a group it began)."""

    initialized = False


def is_initialized() -> bool:
    return _State.initialized


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               port: int = 12321) -> dict:
    """Join the cross-host group; safe to call in single-process runs.

    ``device`` ("cuda", the default, or "cpu") picks the backend: NCCL and
    this rank's card (``LOCAL_RANK`` or the rank, modulo the host's
    cards), or gloo.  Returns {num_processes, process_id, local_devices,
    global_devices} for logging (one card, or one CPU process, a rank)."""
    if coordinator_address is None and "SLURM_JOB_NODELIST" in os.environ:
        head = _first_slurm_node(os.environ["SLURM_JOB_NODELIST"])
        coordinator_address = f"{head}:{port}"
        num_processes = (num_processes if num_processes is not None
                         else int(os.environ.get("SLURM_NTASKS", "1")))
        process_id = (process_id if process_id is not None
                      else int(os.environ.get("SLURM_PROCID", "0")))
    # an explicit coordinator always joins, as the reference's does; only
    # the explicit single-process case (num_processes=1) is a no-op
    if (coordinator_address is not None and num_processes != 1
            and not dist.is_initialized()):
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id (torch.distributed does not "
                             "infer them)")
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(local_cuda_device(process_id))
        dist.init_process_group(backend_for(dev),
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        _State.initialized = True
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    return {"num_processes": world, "process_id": rank,
            "local_devices": 1, "global_devices": world}


def shutdown() -> None:
    if _State.initialized:
        if dist.is_initialized():
            dist.destroy_process_group()
        _State.initialized = False


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist ('n[001-004]' -> 'n001').

    Minimal expansion (no scontrol dependency): handles 'a,b', 'pre[x-y]',
    and plain hostnames."""
    head = nodelist.split(",")[0]
    if "[" in head:
        prefix, rng = head.split("[", 1)
        first = rng.split("-")[0].split(",")[0].rstrip("]")
        return prefix + first
    return head


def global_mesh(axis_name: str = "devices"):
    """A 1-D mesh over every rank of every host (restart fan-out axis)."""
    from limbo_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_name=axis_name)


def host_data_mesh(replicate_axis: str = "hosts",
                   device_axis: str = "devices"):
    """A 2-D (hosts, ranks-per-host) mesh: the outer axis for replicate /
    restart parallelism across hosts, the inner one for sharded algebra
    inside a host.  The hosts are told apart by their names, gathered from
    every rank; ranks must be numbered host by host, as SLURM and torchrun
    number them."""
    import socket

    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    per_host = names.count(names[dist.get_rank()])
    if world % per_host or any(names[i] != names[i - i % per_host]
                               for i in range(world)):
        raise ValueError(f"ranks are not numbered host by host: {names}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, (world // per_host, per_host),
                            mesh_dim_names=(replicate_axis, device_axis))
