"""The kernel library: Exp, SquaredExpARD, Matern 3/2, Matern 5/2 (port of
limbo_tpu/kernels/kernels.py).

Formula parity with limbo (see each class docstring for the reference
file).  Every gram matrix is one pairwise-distance product plus elementwise
math, through the dispatchers of ops/gram.py (the fused kernel on the card
at large sizes).
"""

from __future__ import annotations

import math

import torch

from limbo_tpu_torch.kernels.base import KernelMixin
from limbo_tpu_torch.ops.gram import matern32_gram, matern52_gram, se_gram
from limbo_tpu_torch.utils.device import resolve_device
from limbo_tpu_torch.utils.maths import sq_dist

_DEFAULT_NOISE = 0.01  # limbo defaults::kernel::noise


def _scalar(x: float, device, dtype) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=device)


class _Isotropic(KernelMixin):
    """Shared layout of the isotropic kernels: params [log l, log sigma]."""

    def __init__(self, log_l, log_sigma, log_noise,
                 optimize_noise: bool = False):
        super().__init__()
        self.register_buffer("log_l", log_l)
        self.register_buffer("log_sigma", log_sigma)
        self.register_buffer("log_noise", log_noise)
        self.optimize_noise = optimize_noise

    @classmethod
    def create(cls, sigma_sq: float = 1.0, l: float = 1.0,
               noise: float = _DEFAULT_NOISE, optimize_noise: bool = False,
               device="cuda", dtype=torch.float32):
        dev = resolve_device(device)
        return cls(_scalar(math.log(l), dev, dtype),
                   _scalar(0.5 * math.log(sigma_sq), dev, dtype),
                   _scalar(0.5 * math.log(noise), dev, dtype),
                   optimize_noise=optimize_noise)

    def _core_params(self) -> torch.Tensor:
        return torch.stack([self.log_l, self.log_sigma])

    def _with_core_params(self, p: torch.Tensor):
        return self.replace(log_l=p[0], log_sigma=p[1])

    def k_diag(self, X: torch.Tensor) -> torch.Tensor:
        sf2 = torch.exp(2.0 * self.log_sigma)
        return sf2.to(X.dtype).expand(X.shape[0])


class Exp(_Isotropic):
    """Exponential (squared-exponential, isotropic) kernel.

    k(v1, v2) = sf2 * exp(-|v1-v2|^2 / (2 l^2)).
    Reference: src/limbo/kernel/exp.hpp:74 (params [log l, log sigma]).
    """

    def gram_core(self, X1, X2):
        sf2 = torch.exp(2.0 * self.log_sigma)
        inv_l = torch.exp(-self.log_l)
        return se_gram(X1 * inv_l, X2 * inv_l, sf2)

    def _fused_train_args(self, X):
        sf2 = torch.exp(2.0 * self.log_sigma)
        ones = torch.ones((), dtype=X.dtype, device=X.device)
        return "se", X * torch.exp(-self.log_l), sf2, ones


class SquaredExpARD(KernelMixin):
    """Squared exponential with automatic relevance determination.

    k(v1, v2) = sf2 * exp(-0.5 (v1-v2)^T M (v1-v2)),
    M = A A^T + diag(ell^-2) with optional low-rank A (d x rank).
    Reference: src/limbo/kernel/squared_exp_ard.hpp:82; parameter vector is
    [log ell (d), A column-major (d*rank), log sigma].
    """

    def __init__(self, log_ell, A, log_sigma, log_noise,
                 optimize_noise: bool = False):
        super().__init__()
        self.register_buffer("log_ell", log_ell)
        self.register_buffer("A", A)
        self.register_buffer("log_sigma", log_sigma)
        self.register_buffer("log_noise", log_noise)
        self.optimize_noise = optimize_noise

    @classmethod
    def create(cls, dim: int, rank: int = 0, sigma_sq: float = 1.0,
               noise: float = _DEFAULT_NOISE, optimize_noise: bool = False,
               device="cuda", dtype=torch.float32) -> "SquaredExpARD":
        dev = resolve_device(device)
        return cls(torch.zeros((dim,), dtype=dtype, device=dev),
                   torch.zeros((dim, rank), dtype=dtype, device=dev),
                   _scalar(0.5 * math.log(sigma_sq), dev, dtype),
                   _scalar(0.5 * math.log(noise), dev, dtype),
                   optimize_noise=optimize_noise)

    def _core_params(self) -> torch.Tensor:
        # limbo order: ell, then A by columns (p((j+1)*d + i) = A[i, j]), sigma
        return torch.cat([self.log_ell, self.A.T.reshape(-1),
                          self.log_sigma.reshape(1)])

    def _with_core_params(self, p: torch.Tensor) -> "SquaredExpARD":
        d = self.log_ell.shape[0]
        rank = self.A.shape[1]
        A = p[d:d + d * rank].reshape(rank, d).T
        return self.replace(log_ell=p[:d], A=A, log_sigma=p[d + d * rank])

    def gram_core(self, X1, X2):
        sf2 = torch.exp(2.0 * self.log_sigma)
        inv_ell = torch.exp(-self.log_ell)
        if self.A.shape[1] > 0:
            z = sq_dist(X1 * inv_ell, X2 * inv_ell)
            z = z + sq_dist(X1 @ self.A, X2 @ self.A)
            return sf2 * torch.exp(-0.5 * z)
        return se_gram(X1 * inv_ell, X2 * inv_ell, sf2)

    def k_diag(self, X):
        sf2 = torch.exp(2.0 * self.log_sigma)
        return sf2.to(X.dtype).expand(X.shape[0])

    def _fused_train_args(self, X):
        # |Delta/ell|^2 + |A^T Delta|^2 is one Euclidean distance over the
        # concatenated features [X/ell, X A]
        sf2 = torch.exp(2.0 * self.log_sigma)
        Xs = X * torch.exp(-self.log_ell)
        if self.A.shape[1] > 0:
            Xs = torch.cat([Xs, X @ self.A], dim=1)
        return "se", Xs, sf2, torch.ones((), dtype=X.dtype, device=X.device)

    @property
    def ell(self) -> torch.Tensor:
        return torch.exp(self.log_ell)


class MaternThreeHalves(_Isotropic):
    """Matern nu=3/2 kernel: sf2 * (1 + t) * exp(-t), t = sqrt(3) d / l.

    Reference: src/limbo/kernel/matern_three_halves.hpp:82.
    """

    def gram_core(self, X1, X2):
        sf2 = torch.exp(2.0 * self.log_sigma)
        return matern32_gram(X1, X2, sf2, torch.exp(-self.log_l))

    def _fused_train_args(self, X):
        sf2 = torch.exp(2.0 * self.log_sigma)
        return "matern32", X, sf2, torch.exp(-self.log_l)


class MaternFiveHalves(_Isotropic):
    """Matern nu=5/2: sf2 * (1 + t + 5 d^2/(3 l^2)) * exp(-t), t = sqrt(5) d/l.

    Reference: src/limbo/kernel/matern_five_halves.hpp:84; limbo's default
    BO kernel.
    """

    def gram_core(self, X1, X2):
        sf2 = torch.exp(2.0 * self.log_sigma)
        return matern52_gram(X1, X2, sf2, torch.exp(-self.log_l))

    def _fused_train_args(self, X):
        sf2 = torch.exp(2.0 * self.log_sigma)
        return "matern52", X, sf2, torch.exp(-self.log_l)
