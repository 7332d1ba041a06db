"""Multi-dimensional observations + custom aggregator (the port of
examples/obs_multi.py, after src/examples/obs_multi.cpp): the objective
returns a 2-D observation; the loop maximizes an aggregated scalar, the
negative distance of the observation to (0, 0).

    python3 examples/torch/obs_multi.py                # on the card
    main(device="cpu", iterations=5)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.acqui import UCB
from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling


def eval_fn(x):
    x = np.asarray(x)
    return np.array([x[0] - 0.25, x[1] - 0.75])


def distance_to_target(mu):
    """Aggregator: negative distance of the 2-D observation to (0, 0)."""
    return -torch.sqrt(torch.sum(mu ** 2, dim=-1) + 1e-12)


def main(device="cuda", iterations=40, seed=0):
    bo = BOptimizer(
        acqui=UCB(alpha=0.5),
        init=RandomSampling(10),
        stop=(MaxIterations(iterations),),
        stats_enabled=False,
        device=device,
    )
    gen = torch.Generator(device=bo.device).manual_seed(seed)
    state = bo.optimize(eval_fn, 2, dim_out=2,
                        aggregator=distance_to_target, generator=gen)
    print("best sample:", state.best_sample)  # ~ (0.25, 0.75)
    return state


if __name__ == "__main__":
    main()
