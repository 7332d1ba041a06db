"""External GP baseline: scikit-learn GaussianProcessRegressor (the port's
own copy of limbo_tpu/benchmarks/sklearn_baseline.py; NumPy only, with
scikit-learn imported inside the function, so the module imports on a host
without it).

The reference's regression benchmarks compare against GPy and libGP
(src/benchmarks/regression/gpy.py, docs/benchmark_res_reg.inc:3-5).  GPy is
not in this image, but scikit-learn is — its `GaussianProcessRegressor`
(Rasmussen & Williams Algorithm 2.1, f64 BLAS Cholesky, L-BFGS-B maximum
marginal likelihood) is the same class of external CPU library, so it gives
a *measured third-party* point of comparison rather than a self-written
oracle.

Model match to the suite's GP-SE specs:
  * GP-SE-Full-Rprop  -> ConstantKernel * RBF(ard) + WhiteKernel
    (noise variance learned, like limbo's `optimize_noise=true`)
  * GP-SE-Rprop       -> ConstantKernel * RBF(ard), fixed alpha=noise^2
    (noise fixed at the data-generation level, like kernel/kernel.hpp:55
    `noise` default without optimization)

sklearn optimizes with L-BFGS-B instead of Rprop; that is the library's
native protocol (the reference likewise lets GPy use its own optimizer —
src/benchmarks/regression/gpy.py `m.optimize()`, no restarts), so times are
each library's honest best effort on the same data.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np


def fit_and_eval(X: np.ndarray, Y: np.ndarray, Xq: np.ndarray,
                 Yq: np.ndarray, optimize_noise: bool = True,
                 noise_std: float = 0.01, n_restarts: int = 0,
                 ) -> Tuple[float, float, float]:
    """(mse, learn_s, query_s) for sklearn GPR under the suite protocol.

    Inputs are the suite's unit-cube parameterization (the same arrays the
    port's GP and the f64 oracle see), so MSE is directly comparable.
    """
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import (
        RBF,
        ConstantKernel,
        WhiteKernel,
    )

    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64).reshape(len(X), -1)
    Xq = np.asarray(Xq, dtype=np.float64)
    Yq = np.asarray(Yq, dtype=np.float64).reshape(len(Xq), -1)
    d = X.shape[1]

    kernel = ConstantKernel(1.0, (1e-4, 1e6)) * RBF(
        length_scale=np.ones(d), length_scale_bounds=(1e-3, 1e3))
    if optimize_noise:
        kernel = kernel + WhiteKernel(noise_level=noise_std ** 2,
                                      noise_level_bounds=(1e-12, 1e2))
        alpha = 1e-10
    else:
        alpha = noise_std ** 2
    gpr = GaussianProcessRegressor(kernel=kernel, alpha=alpha,
                                   normalize_y=True,
                                   n_restarts_optimizer=n_restarts,
                                   random_state=0)
    t0 = time.perf_counter()
    gpr.fit(X, Y)
    t_learn = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu = gpr.predict(Xq)
    t_query = time.perf_counter() - t0
    mse = float(np.mean((mu.reshape(Yq.shape) - Yq) ** 2))
    return mse, t_learn, t_query
