"""Multi-output observations with a learned mean function (the port of
examples/obs_multi_auto_mean.py, after src/examples/
obs_multi_auto_mean.cpp): a FunctionARD-wrapped mean whose affine
transform is learned jointly with the kernel hyperparameters
(KernelMeanLFOpt).

    python3 examples/torch/obs_multi_auto_mean.py      # on the card
    main(device="cpu", iterations=5)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.acqui import UCB
from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
from limbo_tpu_torch.kernels import SquaredExpARD
from limbo_tpu_torch.means import ConstantMean, FunctionARD
from limbo_tpu_torch.models.hp_opt import KernelMeanLFOpt
from limbo_tpu_torch.opt import Rprop


def eval_fn(x):
    x = np.asarray(x)
    return np.array([2.0 - np.sum((x - 0.5) ** 2), x.sum()])


def main(device="cuda", iterations=30, seed=0):
    mean = FunctionARD.create(ConstantMean.create(1.0, dim_out=2,
                                                  device=device),
                              dim_out=2, device=device)
    bo = BOptimizer(
        kernel=SquaredExpARD.create(dim=2, device=device),
        mean=mean,
        acqui=UCB(alpha=0.5),
        init=RandomSampling(10),
        stop=(MaxIterations(iterations),),
        hp_opt=KernelMeanLFOpt(optimizer=Rprop(iterations=100)),
        hp_period=10,
        stats_enabled=False,
        device=device,
    )
    gen = torch.Generator(device=bo.device).manual_seed(seed)
    state = bo.optimize(eval_fn, 2, dim_out=2, generator=gen)
    print("best sample:", state.best_sample)
    return state


if __name__ == "__main__":
    main()
