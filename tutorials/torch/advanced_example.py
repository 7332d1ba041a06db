"""Advanced BO tutorial (the port of tutorials/advanced_example.py, after
src/tutorials/advanced_example.cpp): a custom kernel, mean, acquisition,
inner optimizer and stop criterion, hyperparameter learning, stats, and a
resume without reset (bo_base.hpp:249, reset=false).

    python3 tutorials/torch/advanced_example.py        # on the card
    main(device="cpu", iterations=3)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.acqui import EI
from limbo_tpu_torch.bo import BOptimizer, LHS, MaxIterations, stats
from limbo_tpu_torch.kernels import SquaredExpARD
from limbo_tpu_torch.means import ConstantMean
from limbo_tpu_torch.models.hp_opt import KernelLFOpt
from limbo_tpu_torch.opt import Cmaes, ParallelRepeater, Rprop


def eval_fn(x):
    x = np.asarray(x)
    return np.array([-np.sum((x - 0.4) ** 2) + 0.1 * np.cos(8 * x[0])])


def main(device="cuda", iterations=25, seed=0):
    bo = BOptimizer(
        kernel=SquaredExpARD.create(dim=2, optimize_noise=True,
                                    device=device),
        mean=ConstantMean.create(0.0, device=device),
        acqui=EI(jitter=0.01),
        acqui_optimizer=Cmaes(iterations=60, pop_size=16),
        init=LHS(samples=12),
        stop=(MaxIterations(iterations),),
        hp_opt=KernelLFOpt(
            optimizer=ParallelRepeater(sub=Rprop(iterations=100),
                                       repeats=4, epsilon=0.5)),
        hp_period=10,
        stats=(stats.ConsoleSummary(),),
        res_base_dir=None,
        device=device,
    )

    def gen(k):
        return torch.Generator(device=bo.device).manual_seed(seed + k)

    state = bo.optimize(eval_fn, 2, generator=gen(0))
    print("first run best:", state.best_sample)
    # resume without resetting (bo_base.hpp:249, reset=false)
    state = bo.optimize(eval_fn, 2, reset=False, state=state,
                        generator=gen(1))
    print("after resume:", state.best_sample, state.total_iterations)
    return state


if __name__ == "__main__":
    main()
