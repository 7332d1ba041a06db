"""Regression benchmark test functions (port of
limbo_tpu/benchmarks/regression_functions.py).

Reference: src/benchmarks/regression/test_functions.hpp and the protocol
config waf_tools/regression_benchmarks.json: functions with native bounds
(inputs are sampled uniformly in `bounds` and scaled from the unit cube):
Rastrigin (dims 1,2,4,8), GramacyLee (1), Step (1), RobotArm (8),
OTLCircuit (6), PistonSimulation (7), PlanarInverseDynamics I/II (6).
Each is torch code over the last axis: a point (d,) or a batch (..., d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class RegressionFunction:
    name: str
    fn: Callable                        # (..., d) native-domain -> (...)
    bounds: np.ndarray                  # (d, 2) native bounds
    dims: Sequence[int]                 # benchmark dims (json "dimensions")

    def scale(self, u: torch.Tensor) -> torch.Tensor:
        """Map [0,1]^d samples into the native domain."""
        b = torch.as_tensor(self.bounds_for_dim(u.shape[-1]), dtype=u.dtype,
                            device=u.device)
        return b[:, 0] + u * (b[:, 1] - b[:, 0])

    def bounds_for_dim(self, d: int) -> np.ndarray:
        b = self.bounds
        if b.shape[0] == 1:
            return np.repeat(b, d, axis=0)
        if b.shape[0] != d:
            raise ValueError(f"{self.name} has {b.shape[0]} dims, not {d}")
        return b


def _rastrigin(x):
    return 10.0 * x.shape[-1] + torch.sum(
        x * x - 10.0 * torch.cos(2.0 * math.pi * x), dim=-1)


def _gramacy_lee(x):
    v = x[..., 0]
    return torch.sin(10.0 * math.pi * v) / (2.0 * v) + (v - 1.0) ** 4


def _step(x):
    return torch.where(x[..., 0] <= 0.0, 0.0, 1.0).to(x.dtype)


def _robot_arm(x):
    q = x[..., :4]
    L = x[..., 4:]
    csum = torch.cumsum(q, dim=-1)
    u = torch.sum(L * torch.cos(csum), dim=-1)
    v = torch.sum(L * torch.sin(csum), dim=-1)
    return torch.sqrt(u * u + v * v)


def _otl_circuit(x):
    Rb1, Rb2, Rf, Rc1, Rc2, beta = x.unbind(-1)
    Vb1 = 12.0 * Rb2 / (Rb1 + Rb2)
    den = beta * (Rc2 + 9.0) + Rf
    term1 = (Vb1 + 0.74) * beta * (Rc2 + 9.0) / den
    term2 = 11.35 * Rf / den
    term3 = 0.74 * Rf * beta * (Rc2 + 9.0) / (den * Rc1)
    return term1 + term2 + term3


def _piston(x):
    M, S, V0, k, P0, Ta, T0 = x.unbind(-1)
    A = P0 * S + 19.62 * M - k * V0 / S
    V = S * (torch.sqrt(A * A + 4.0 * k * P0 * V0 * Ta / T0) - A) / (2.0 * k)
    return 2.0 * math.pi * torch.sqrt(
        M / (k + S * S * P0 * V0 * Ta / (T0 * V * V)))


def _planar_inverse_dynamics(x, torque_idx: int):
    ddq0, ddq1, dq0, dq1, _, q1 = x.unbind(-1)
    m1 = l1 = 0.5
    m2 = l2 = 0.5
    r1, r2 = l1 / 2.0, l2 / 2.0
    I1 = m1 * l1 * l1 / 12.0
    I2 = m2 * l2 * l2 / 12.0
    a = I1 + I2 + m1 * r1 * r1 + m2 * (l1 * l1 + r2 * r2)
    b = m2 * l1 * r2
    delta = I2 + m2 * r2 * r2
    c1 = torch.cos(q1)
    s1 = torch.sin(q1)
    # tau = M ddq + C dq, M = [[a + 2b c1, delta + b c1], [delta + b c1,
    # delta]], C = [[-b s1 dq1, -b s1 (dq0 + dq1)], [b s1 dq0, 0]]
    if torque_idx == 0:
        return (((a + 2 * b * c1) * ddq0 + (delta + b * c1) * ddq1)
                + ((-b * s1 * dq1) * dq0 + (-b * s1 * (dq0 + dq1)) * dq1))
    return (((delta + b * c1) * ddq0 + delta * ddq1)
            + ((b * s1 * dq0) * dq0 + 0.0 * dq1))


RASTRIGIN_REG = RegressionFunction(
    "Rastrigin", _rastrigin, np.array([[-5.12, 5.12]]), (1, 2, 4, 8))
GRAMACY_LEE = RegressionFunction(
    "GramacyLee", _gramacy_lee, np.array([[0.5, 2.5]]), (1,))
STEP = RegressionFunction(
    "Step", _step, np.array([[-2.0, 2.0]]), (1,))
ROBOT_ARM = RegressionFunction(
    "RobotArm", _robot_arm,
    np.array([[0.0, 2 * math.pi]] * 4 + [[0.0, 1.0]] * 4), (8,))
OTL_CIRCUIT = RegressionFunction(
    "OTLCircuit", _otl_circuit,
    np.array([[50., 150.], [25., 70.], [0.5, 3.], [1.2, 2.5],
              [0.25, 1.2], [50., 300.]]), (6,))
PISTON = RegressionFunction(
    "PistonSimulation", _piston,
    np.array([[30., 60.], [0.005, 0.020], [0.002, 0.010], [1000., 5000.],
              [90000., 110000.], [290., 296.], [340., 360.]]), (7,))
PLANAR_I = RegressionFunction(
    "PlanarInverseDynamicsI", lambda x: _planar_inverse_dynamics(x, 0),
    np.array([[-2 * math.pi, 2 * math.pi]] * 4 + [[-math.pi, math.pi]] * 2),
    (6,))
PLANAR_II = RegressionFunction(
    "PlanarInverseDynamicsII", lambda x: _planar_inverse_dynamics(x, 1),
    np.array([[-2 * math.pi, 2 * math.pi]] * 4 + [[-math.pi, math.pi]] * 2),
    (6,))

ALL_REGRESSION: List[RegressionFunction] = [
    RASTRIGIN_REG, GRAMACY_LEE, STEP, ROBOT_ARM, OTL_CIRCUIT, PISTON,
    PLANAR_I, PLANAR_II,
]
