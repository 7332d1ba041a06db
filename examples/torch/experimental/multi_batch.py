"""Batch multi-objective BO: exact q-EHVI proposals on mop2 (the port of
examples/experimental/multi_batch.py).  Each iteration proposes a q-point
batch by jointly maximizing the exact q-EHVI (ops/ehvi.qehvi_exact_max:
inclusion-exclusion over the shared box decomposition, Gauss-Hermite over
the joint posterior), for objectives evaluated q at a time.

    python3 examples/torch/experimental/multi_batch.py # on the card
    main(device="cpu", iterations=2)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo.multi import Ehvi
from limbo_tpu_torch.bo.stop import MaxIterations
from limbo_tpu_torch.ops.pareto import hypervolume_2d


def mop2(x):
    x = np.asarray(x, dtype=np.float64) * 4.0 - 2.0
    n = len(x)
    f1 = 1.0 - np.exp(-np.sum((x - 1.0 / np.sqrt(n)) ** 2))
    f2 = 1.0 - np.exp(-np.sum((x + 1.0 / np.sqrt(n)) ** 2))
    return np.array([-f1, -f2])


def main(device="cuda", iterations=10, seed=0):
    ref = (-1.1, -1.1)
    print("== exact q-EHVI (q=2) on mop2 ==")
    loop = Ehvi(ref=ref, q=2, gh_nodes=12, stop=(MaxIterations(iterations),),
                device=device)
    Xp, Yp = loop.optimize(
        mop2, 2, generator=torch.Generator(device=device).manual_seed(seed))
    hv = float(hypervolume_2d(torch.as_tensor(Yp), torch.as_tensor(ref,
                                                    dtype=torch.float64)))
    print(f"evaluations: {len(loop.X)} (10 init + {iterations} iters x q=2)")
    print(f"front size: {len(Xp)}, hypervolume vs ref {ref}: {hv:.4f}")
    return Xp, Yp, hv


if __name__ == "__main__":
    main()
