"""Multi-objective BO on mop2 / zdt2 with EHVI, NSBO and ParEGO (the port
of examples/experimental/multi.py, after src/examples/experimental/
multi.cpp).  Objectives are MAXIMIZED (negated); the loops run in f64, as
the reference's do.

    python3 examples/torch/experimental/multi.py       # on the card
    main(device="cpu", iterations=(2, 2, 2))           # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo.multi import Ehvi, Nsbo, Parego
from limbo_tpu_torch.bo.stop import MaxIterations


def mop2(x):
    """mop2 (2 objectives, maximized as -f) on [0, 1]^d mapped to
    [-2, 2]^d, from a numpy array to a (2,) one in f64."""
    x = np.asarray(x, dtype=np.float64) * 4.0 - 2.0
    n = len(x)
    f1 = 1.0 - np.exp(-np.sum((x - 1.0 / np.sqrt(n)) ** 2))
    f2 = 1.0 - np.exp(-np.sum((x + 1.0 / np.sqrt(n)) ** 2))
    return np.array([-f1, -f2])


def zdt2(x):
    """zdt2 (2 objectives, maximized as -f)."""
    x = np.asarray(x, dtype=np.float64)
    f1 = x[0]
    g = 1.0 + 9.0 * np.mean(x[1:]) if len(x) > 1 else 1.0
    return np.array([-f1, -g * (1.0 - (f1 / g) ** 2)])


def main(device="cuda", iterations=(20, 10, 15), seed=0):
    def gen(k):
        return torch.Generator(device=device).manual_seed(seed + k)

    fronts = {}
    print("== EHVI on mop2 ==")
    ehvi = Ehvi(ref=(-1.1, -1.1), stop=(MaxIterations(iterations[0]),),
                device=device)
    fronts["ehvi"] = ehvi.optimize(mop2, 2, generator=gen(0))
    print(f"front size: {len(fronts['ehvi'][0])}")

    print("== NSBO on mop2 ==")
    nsbo = Nsbo(n_objs=2, stop=(MaxIterations(iterations[1]),),
                device=device)
    fronts["nsbo"] = nsbo.optimize(mop2, 2, generator=gen(1))
    print(f"front size: {len(fronts['nsbo'][0])}")

    print("== ParEGO on zdt2 ==")
    parego = Parego(n_objs=2, iterations=iterations[2], device=device)
    fronts["parego"] = parego.optimize(zdt2, 3, generator=gen(2))
    print(f"front size: {len(fronts['parego'][0])}")
    return fronts


if __name__ == "__main__":
    main()
