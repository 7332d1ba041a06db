"""Constrained BO (the port of examples/experimental/cbo.py, after
src/examples/experimental/cbo.cpp): maximize a 1-D objective subject to a
binary feasibility constraint, feasible where x < 0.6.

    python3 examples/torch/experimental/cbo.py         # on the card
    main(device="cpu", iterations=5)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo.cbo import CBOptimizer
from limbo_tpu_torch.bo.stop import MaxIterations


def eval_fn(x):
    """Returns [objective, constraint]; constraint obs 1 = feasible."""
    v = float(np.atleast_1d(x)[0])
    obj = np.exp(-((v - 0.8) ** 2) / 0.05)
    feasible = 1.0 if v < 0.6 else 0.0
    return np.array([obj, feasible])


def main(device="cuda", iterations=30, seed=0):
    bo = CBOptimizer(nb_constraints=1, stop=(MaxIterations(iterations),),
                     device=device)
    bo.optimize(eval_fn, 1,
                generator=torch.Generator(device=bo.device).manual_seed(seed))
    print("best feasible sample:", bo.best_sample,
          "obs:", bo.best_observation)
    return bo


if __name__ == "__main__":
    main()
