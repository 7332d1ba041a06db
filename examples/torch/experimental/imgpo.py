"""IMGPO (the port of examples/experimental/imgpo.py, after
src/examples/experimental/imgpo.cpp): the partition tree with GP-based
upper bounds, 60 evaluations on a 2-D objective.

    python3 examples/torch/experimental/imgpo.py       # on the card
    main(device="cpu", max_evals=20)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo.imgpo import IMGPO


def f(x):
    x = np.asarray(x)
    return -np.sum((x - 0.35) ** 2) + np.prod(np.cos(3 * x)) * 0.1


def main(device="cuda", max_evals=60, seed=0):
    opt = IMGPO(max_evals=max_evals, device=device)
    opt.optimize(f, 2,
                 generator=torch.Generator(device=opt.device).manual_seed(seed))
    print("best:", opt.best_sample, "->", opt.best_value)
    return opt


if __name__ == "__main__":
    main()
