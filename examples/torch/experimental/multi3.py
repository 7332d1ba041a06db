"""3-objective EHVI BO on DTLZ2, the exact 3-D EHVI loop (the port of
examples/experimental/multi3.py): the device box-decomposition EHVI
(ops/ehvi.py) drives a 3-objective run end to end.

    python3 examples/torch/experimental/multi3.py      # on the card
    main(device="cpu", iterations=2)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo.multi import Ehvi
from limbo_tpu_torch.bo.stop import MaxIterations


def dtlz2_3(x):
    """DTLZ2 with 3 objectives on [0,1]^d (maximized as -f)."""
    x = np.asarray(x, dtype=np.float64)
    g = np.sum((x[2:] - 0.5) ** 2)
    c1, s1 = np.cos(0.5 * np.pi * x[0]), np.sin(0.5 * np.pi * x[0])
    c2, s2 = np.cos(0.5 * np.pi * x[1]), np.sin(0.5 * np.pi * x[1])
    return np.array([-(1 + g) * c1 * c2, -(1 + g) * c1 * s2,
                     -(1 + g) * s1])


def main(device="cuda", iterations=15, seed=0):
    print("== exact 3-D EHVI on DTLZ2 (3 objectives) ==")
    ehvi = Ehvi(ref=(-1.2, -1.2, -1.2), stop=(MaxIterations(iterations),),
                device=device)
    Xp, Yp = ehvi.optimize(
        dtlz2_3, 3, generator=torch.Generator(device=device).manual_seed(seed))
    print(f"front size: {len(Xp)}")
    # every front point should be near the unit sphere (the DTLZ2 front)
    radii = np.linalg.norm(Yp, axis=1)
    print(f"front radii: min={radii.min():.3f} max={radii.max():.3f} "
          f"(true front: 1.0)")
    return Xp, Yp


if __name__ == "__main__":
    main()
