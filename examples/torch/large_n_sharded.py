"""BO past one card's memory with the plain BOptimizer surface (the port
of examples/large_n_sharded.py).

``DistributedBOptimizer(mesh, ...)`` is the user-facing wrapper over the
sharded large-n stack (row-sharded Cholesky fit, column-sharded K^-1
panels, distributed-solve appends): the same optimize / stats / stop
surface as BOptimizer, with the model spread over the mesh's ranks, one
process a card.

    python3 examples/torch/large_n_sharded.py          # one rank (NCCL)
    torchrun --nproc-per-node 4 examples/torch/large_n_sharded.py

Alone it makes a group of one (``parallel/mesh.start_group``); under
torchrun every rank joins the group torchrun describes
(``parallel/multihost.initialize``, from WORLD_SIZE, RANK, MASTER_ADDR and
MASTER_PORT).  ``main(device="cpu", block=8)`` runs one gloo rank on the
CPU; on the card the block is the panel kernel's 128.
"""

import contextlib
import os

import numpy as np
import torch

from limbo_tpu_torch.acqui import UCB
from limbo_tpu_torch.bo import (DistributedBOptimizer, MaxIterations,
                                RandomSampling)
from limbo_tpu_torch.opt import RandomRestarts, Rprop
from limbo_tpu_torch.parallel import mesh as pmesh, multihost


def objective(x):
    """Host-evaluated objective (a robot episode, a simulation, ...)."""
    x = np.asarray(x)
    return np.array([-np.sum((x - 0.3) ** 2)])


def _group(device):
    """The process group this run joins: torchrun's, else one of its own."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return pmesh.start_group(device=device)
    multihost.initialize(
        coordinator_address=(f"{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}"),
        num_processes=world, process_id=int(os.environ["RANK"]),
        device=device)
    stack = contextlib.ExitStack()
    stack.callback(multihost.shutdown)
    return stack


def main(device="cuda", iterations=10, block=128, seed=0):
    with _group(device):
        mesh = pmesh.make_mesh(axis_name="rows")
        n_ranks = mesh.size()
        bo = DistributedBOptimizer(
            mesh, block=block,
            acqui=UCB(alpha=0.5),
            acqui_optimizer=RandomRestarts(sub=Rprop(iterations=10),
                                           repeats=4, sweep_samples=64),
            init=RandomSampling(20),
            stop=(MaxIterations(iterations),),
            stats_enabled=False)
        gen = torch.Generator(device=bo.device).manual_seed(seed)
        state = bo.optimize(objective, 3, generator=gen)
        print(f"ranks: {n_ranks}, capacity: {state.gp.capacity} "
              f"(factor sharded {n_ranks} x {state.gp.capacity // n_ranks} "
              f"rows)")
        print(f"n = {state.gp.n}, best = {state.best_value:.5f} "
              f"at {state.best_sample}")
        return state


if __name__ == "__main__":
    main()
