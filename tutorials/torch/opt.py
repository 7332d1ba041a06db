"""Standalone inner-optimizer tutorial (the port of tutorials/opt.py,
after src/tutorials/opt.cpp): the opt layer used directly, without any GP
or BO machinery.  An optimizer maximizes a function of a (R, d) batch of
points, differentiable with autograd, from a start point.

    python3 tutorials/torch/opt.py                     # on the card
    main(device="cpu")                                 # on the CPU
"""

import torch

from limbo_tpu_torch.opt import Cmaes, DirectL, GridSearch, ParallelRepeater, Rprop


def my_function(X):
    """Maximize -(x - 0.6)^2 over [0,1]^2, one value a row of X."""
    return -torch.sum((X - 0.6) ** 2, dim=-1)


def main(device="cuda", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    init = torch.full((2,), 0.5, device=device)
    results = {}
    for name, opt in [
        ("rprop", Rprop(iterations=100)),
        ("repeated rprop", ParallelRepeater(sub=Rprop(iterations=100),
                                            repeats=8)),
        ("grid", GridSearch(bins=20)),
        ("cmaes", Cmaes(iterations=60)),
        ("direct-l", DirectL(rounds=32, splits_per_round=8)),
    ]:
        res = opt(my_function, init, gen, True)
        results[name] = (res.x.cpu().numpy(), float(res.value))
        print(f"{name:16s} -> x={results[name][0]} "
              f"value={results[name][1]:.6f}")
    return results


if __name__ == "__main__":
    main()
