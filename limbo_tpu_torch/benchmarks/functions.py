"""The BO benchmark test functions (port of limbo_tpu/benchmarks/functions.py).

Reference: src/benchmarks/limbo/testfunctions.hpp:110-360: Sphere,
Ellipsoid (with the BBOB t_osz transform), Rastrigin, Hartmann3, Hartmann6,
GoldsteinPrice (log-normalized), BraninNormalized and SixHumpCamel; all on
[0,1]^d, minimized, with known solutions for the accuracy
|f(best) - f(x*)| (bench.cpp:146-157).

Each function is torch code over the last axis, so one call takes a point
(d,) or a batch (..., d).  A function with constant tables (Hartmann's A
and P) is made by ``make(device, dtype)``, which builds the tables on the
device once: ``as_max_objective`` runs inside a captured BO iteration,
where a copy from the host cannot be captured.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch


@dataclass(frozen=True)
class TestFunction:
    __test__ = False                # not a pytest test class

    name: str
    dim_in: int
    # make(device, dtype) -> f, f: (..., d) tensor -> (...), minimize
    make: Callable
    solutions: np.ndarray           # (n_sols, d) argmin(s) in [0,1]^d

    def fn(self, x: torch.Tensor) -> torch.Tensor:
        """f(x) on x's device and dtype (builds the tables anew: for
        one-off calls; a loop takes ``make`` once)."""
        return self.make(x.device, x.dtype)(x)

    @property
    def f_opt(self) -> float:
        """The least value at the solutions, in f64."""
        return float(self.fn(torch.as_tensor(self.solutions,
                                             dtype=torch.float64)).min())

    def accuracy(self, best_observed: float) -> float:
        """|f(best) - f(x*)| (bench.cpp accuracy)."""
        return abs(best_observed - self.f_opt)

    def as_max_objective(self, device="cuda", dtype=torch.float32):
        """(d,) -> (1,) maximization wrapper for the BO loops, its tables
        built once on `device`."""
        f = self.make(torch.device(device), dtype)
        return lambda x: -f(x).reshape(1)


def _plain(f):
    """make() for a function with no tables."""
    return lambda device, dtype: f


def _sphere(x):
    return torch.sum((x - 0.5) ** 2, dim=-1)


def _ellipsoid(x):
    # t_osz transform exactly as testfunctions.hpp:102-108:
    # sign(z) * exp(hat + 0.049*sin(c1*hat) + sin(c2*hat))
    z = x - 0.5
    hat = torch.where(z != 0, torch.log(torch.abs(torch.where(z == 0, 1.0,
                                                              z))), 0.0)
    pos = z > 0
    c1 = torch.where(pos, torch.full_like(z, 10.0), torch.full_like(z, 5.5))
    c2 = torch.where(pos, torch.full_like(z, 7.9), torch.full_like(z, 3.1))
    zz = torch.sign(z) * torch.exp(hat + 0.049 * torch.sin(c1 * hat)
                                   + torch.sin(c2 * hat))
    d = x.shape[-1]
    w = torch.pow(10.0, torch.arange(d, dtype=x.dtype, device=x.device)
                  / (d - 1.0))
    return torch.sum(w * zz * zz + 1.0, dim=-1)


def _rastrigin(x):
    z = 2.0 * x - 1.0
    d = x.shape[-1]
    return 10.0 * d + torch.sum(z * z - 10.0 * torch.cos(2.0 * math.pi * z),
                                dim=-1)


_H3_A = np.array([[3.0, 10., 30.], [0.1, 10., 35.],
                  [3.0, 10., 30.], [0.1, 10., 35.]])
_H3_P = np.array([[0.3689, 0.1170, 0.2673], [0.4699, 0.4387, 0.7470],
                  [0.1091, 0.8732, 0.5547], [0.0381, 0.5743, 0.8828]])
_H_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array([[10., 3., 17., 3.5, 1.7, 8.],
                  [0.05, 10., 17., 0.1, 8., 14.],
                  [3., 3.5, 1.7, 10., 17., 8.],
                  [17., 8., 0.05, 10., 0.1, 14.]])
_H6_P = np.array([[0.1312, 0.1696, 0.5569, 0.0124, 0.8283, 0.5886],
                  [0.2329, 0.4135, 0.8307, 0.3736, 0.1004, 0.9991],
                  [0.2348, 0.1451, 0.3522, 0.2883, 0.3047, 0.6650],
                  [0.4047, 0.8828, 0.8732, 0.5743, 0.1091, 0.0381]])


def _hartmann(A, P):
    def make(device, dtype):
        a, p, al = (torch.as_tensor(t, dtype=dtype, device=device)
                    for t in (A, P, _H_ALPHA))

        def f(x):
            s = torch.sum(a * (x[..., None, :] - p) ** 2, dim=-1)
            return -torch.sum(al * torch.exp(-s), dim=-1)
        return f
    return make


def _goldstein_price(x):
    z = 4.0 * x - 2.0
    x1, x2 = z[..., 0], z[..., 1]
    fact1a = (x1 + x2 + 1.0) ** 2
    fact1b = (19. - 14. * x1 + 3. * x1 ** 2 - 14. * x2 + 6. * x1 * x2
              + 3. * x2 ** 2)
    fact1 = 1.0 + fact1a * fact1b
    fact2a = (2. * x1 - 3. * x2) ** 2
    fact2b = (18. - 32. * x1 + 12. * x1 ** 2 + 48. * x2 - 36. * x1 * x2
              + 27. * x2 ** 2)
    fact2 = 30.0 + fact2a * fact2b
    return (torch.log(fact1 * fact2) - 8.693) / 2.427


def _branin_normalized(x):
    x1 = x[..., 0] * 15.0 - 5.0
    x2 = x[..., 1] * 15.0
    term1 = (x2 - 5.1 * x1 ** 2 / (4 * math.pi ** 2)
             + 5.0 * x1 / math.pi - 6.0) ** 2
    term2 = (10.0 - 10.0 / (8.0 * math.pi)) * torch.cos(x1)
    return (term1 + term2 - 44.81) / 51.95


def _six_hump_camel(x):
    x1 = -3.0 + 6.0 * x[..., 0]
    x2 = -2.0 + 4.0 * x[..., 1]
    x1_2, x2_2 = x1 * x1, x2 * x2
    return ((4.0 - 2.1 * x1_2 + x1_2 * x1_2 / 3.0) * x1_2 + x1 * x2
            + (-4.0 + 4.0 * x2_2) * x2_2)


SPHERE = TestFunction("Sphere", 2, _plain(_sphere), np.array([[0.5, 0.5]]))
ELLIPSOID = TestFunction("Ellipsoid", 2, _plain(_ellipsoid),
                         np.array([[0.5, 0.5]]))
RASTRIGIN = TestFunction("Rastrigin", 4, _plain(_rastrigin),
                         np.full((1, 4), 0.5))
HARTMANN3 = TestFunction("Hartmann3", 3, _hartmann(_H3_A, _H3_P),
                         np.array([[0.114614, 0.555649, 0.852547]]))
HARTMANN6 = TestFunction("Hartmann6", 6, _hartmann(_H6_A, _H6_P),
                         np.array([[0.20169, 0.150011, 0.476874,
                                    0.275332, 0.311652, 0.6573]]))
GOLDSTEIN_PRICE = TestFunction("GoldsteinPrice", 2, _plain(_goldstein_price),
                               np.array([[0.5, 0.25]]))
BRANIN = TestFunction(
    "BraninNormalized", 2, _plain(_branin_normalized),
    np.array([[(-math.pi + 5) / 15, 12.275 / 15],
              [(math.pi + 5) / 15, 2.275 / 15],
              [(9.42478 + 5) / 15, 2.475 / 15]]))
SIX_HUMP_CAMEL = TestFunction(
    "SixHumpCamel", 2, _plain(_six_hump_camel),
    np.array([[(0.0898 + 3) / 6, (-0.7126 + 2) / 4],
              [(-0.0898 + 3) / 6, (0.7126 + 2) / 4]]))

ALL_FUNCTIONS: List[TestFunction] = [
    SPHERE, ELLIPSOID, RASTRIGIN, HARTMANN3, HARTMANN6,
    GOLDSTEIN_PRICE, BRANIN, SIX_HUMP_CAMEL,
]
