"""Basic BO tutorial (the port of tutorials/basic_example.py, after
src/tutorials/basic_example.cpp): maximize a simple 1-D function with all
defaults.

    python3 tutorials/torch/basic_example.py           # on the card
    main(device="cpu", iterations=3)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo import BOptimizer, MaxIterations


def eval_fn(x):
    return np.array([-(np.atleast_1d(x)[0] - 0.75) ** 2])


def main(device="cuda", iterations=30, seed=0):
    bo = BOptimizer(stop=(MaxIterations(iterations),), stats_enabled=False,
                    device=device)
    state = bo.optimize(
        eval_fn, 1, generator=torch.Generator(device=bo.device).manual_seed(
            seed))
    print("best sample:", state.best_sample, "->", state.best_value)
    return state


if __name__ == "__main__":
    main()
