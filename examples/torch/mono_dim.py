"""2-in / 1-out Bayesian optimization with GP-UCB (the port of
examples/mono_dim.py, after src/examples/mono_dim.cpp:46-120): maximize a
1-peak objective over [0,1]^2 with GP-UCB, random init, stats written to a
hostname_date_pid result directory under ``res_base_dir``.

    python3 examples/torch/mono_dim.py                 # on the card
    main(device="cpu", iterations=5)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.acqui import GP_UCB
from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling, stats


def fit_eval(x):
    # same shape as mono_dim.cpp's fit_eval: peak at (0.25, 0.75)
    x = np.asarray(x)
    return np.array([-np.sum((x - np.array([0.25, 0.75])) ** 2)])


def main(device="cuda", iterations=40, res_base_dir=".", seed=0):
    bo = BOptimizer(
        acqui=GP_UCB(),
        init=RandomSampling(10),
        stop=(MaxIterations(iterations),),
        stats=(stats.ConsoleSummary(), stats.Samples(), stats.Observations(),
               stats.BestObservations(), stats.AggregatedObservations()),
        res_base_dir=res_base_dir,
        device=device,
    )
    gen = torch.Generator(device=bo.device).manual_seed(seed)
    state = bo.optimize(fit_eval, 2, generator=gen)
    print("best sample:", state.best_sample,
          "best observation:", state.best_observation)
    return state


if __name__ == "__main__":
    main()
