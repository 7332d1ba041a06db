"""Covariance-function base machinery (port of limbo_tpu/kernels/base.py).

A kernel is an ``nn.Module`` whose hyperparameters are log-space tensors
(buffers), in the reference's layouts; ``params`` / ``with_params`` give the
flat limbo h_params vector, with the noise parameter appended last iff
``optimize_noise`` (limbo kernel/kernel.hpp:74-125).  The fundamental
operation is ``gram(X1, X2)``, a full cross-covariance from one
pairwise-distance product plus elementwise math.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.utils.modules import HyperModule

JITTER = 1e-8


def effective_jitter(dtype) -> float:
    """Dtype-aware diagonal jitter: limbo's 1e-8 in f64; ~32*eps in f32
    (1e-8 is below f32 resolution next to unit diagonals)."""
    return max(JITTER, 32 * float(torch.finfo(dtype).eps))


class KernelMixin(HyperModule):
    """Shared behaviour for all kernels.

    Subclasses register buffer ``log_noise`` (log of the noise std), set
    ``optimize_noise``, and provide ``_core_params()``,
    ``_with_core_params(p)``, ``gram_core(X1, X2)`` and ``k_diag(X)``.
    """

    optimize_noise: bool = False

    # -- noise ---------------------------------------------------------------

    @property
    def noise(self) -> torch.Tensor:
        """Noise variance (limbo BaseKernel::noise, kernel.hpp:127)."""
        return torch.exp(2.0 * self.log_noise)

    # -- hyperparameter vector (limbo h_params protocol) ---------------------

    @property
    def params(self) -> torch.Tensor:
        """Flat log-space hyperparameters; noise appended iff optimized."""
        core = self._core_params()
        if self.optimize_noise:
            return torch.cat([core, self.log_noise.reshape(1)])
        return core

    @property
    def params_size(self) -> int:
        return int(self._core_params().shape[0]) + int(self.optimize_noise)

    def with_params(self, p: torch.Tensor):
        """Rebuild the kernel from a flat log-space parameter vector."""
        if self.optimize_noise:
            return self._with_core_params(p[:-1]).replace(log_noise=p[-1])
        return self._with_core_params(p)

    # -- evaluation ----------------------------------------------------------

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """Scalar covariance k(x1, x2) for two (d,) points (no noise)."""
        return self.gram_core(x1[None, :], x2[None, :])[0, 0]

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """(n, m) cross-covariance, no noise (query path)."""
        return self.gram_core(X1, X2)

    def gram_train(self, X: torch.Tensor) -> torch.Tensor:
        """(n, n) training covariance: gram + (noise + jitter) * I
        (limbo kernel.hpp:81-84, with the dtype-aware jitter)."""
        K = self.gram_core(X, X)
        eye = torch.eye(X.shape[0], dtype=K.dtype, device=K.device)
        return K + self.train_diag_add(X) * eye

    def gram_train_masked(self, X: torch.Tensor, n: int, extra_jitter=None
                          ) -> torch.Tensor:
        """Cholesky-ready padded training covariance: equal to
        ``masked_identity_gram(gram_train(X) [+ extra*I], arange(N) < n)``,
        in one fused kernel pass on the card for kernels with a
        single-distance form (ops/gram.gram_train_masked)."""
        args = self._fused_train_args(X)
        if args is not None:
            from limbo_tpu_torch.ops.gram import gram_train_masked as _fused

            form, Xs, sf2, inv_l = args
            # scalar train_diag_add: every fused kernel has constant prior
            # variance k_diag == sf2 (see train_diag_add)
            diag_add = self.noise + effective_jitter(X.dtype) * torch.clamp(
                sf2, min=1.0)
            if extra_jitter is not None:
                diag_add = diag_add + extra_jitter
            return _fused(form, Xs, sf2, inv_l, diag_add, n)
        from limbo_tpu_torch.utils.maths import masked_identity_gram

        K = self.gram_train(X)
        if extra_jitter is not None:
            K = K + extra_jitter * torch.eye(X.shape[0], dtype=K.dtype,
                                             device=K.device)
        mask = (torch.arange(X.shape[0], device=X.device) < n).to(X.dtype)
        return masked_identity_gram(K, mask)

    def _fused_train_args(self, X: torch.Tensor):
        """(form, scaled_inputs, sf2, inv_l) for the fused train-gram path,
        or None when this kernel has no single-distance form."""
        return None

    def train_diag_add(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) additive training-diagonal term: noise + scale-aware jitter
        (the jitter scales with k_diag when that exceeds 1; see
        limbo_tpu/kernels/base.py:141-155)."""
        kd = self.k_diag(X)
        return self.noise + effective_jitter(kd.dtype) * torch.clamp(kd,
                                                                     min=1.0)
