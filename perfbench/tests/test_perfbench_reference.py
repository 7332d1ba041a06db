"""The float64 reference against an independent computation at a tiny size
(NumPy: the covariance entry by entry, a dense inverse, the posterior of
each prefix solved on its own, the gradients by central differences), and
the controls' rounding."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import control, gp64

NOISE = 0.09


def data(n=40, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = np.sin(3 * X.sum(1, keepdims=True)) + 0.3 * rng.standard_normal((n, 1))
    theta = np.concatenate([np.log(rng.uniform(0.2, 0.5, d)), [0.1]])
    return X, Y, theta


def np_cov(A, B, theta):
    d = A.shape[1]
    ell, sf2 = np.exp(theta[:d]), math.exp(2 * theta[d])
    K = np.empty((len(A), len(B)))
    for i, a in enumerate(A):
        for j, b in enumerate(B):
            K[i, j] = sf2 * math.exp(-0.5 * np.sum(((a - b) / ell) ** 2))
    return K


def np_train(X, theta):
    d = X.shape[1]
    sf2 = math.exp(2 * theta[d])
    return np_cov(X, X, theta) + (NOISE + 32 * 2.0 ** -23 * max(sf2, 1.0)) \
        * np.eye(len(X))


def np_lml(X, Y, theta):
    K = np_train(X, theta)
    r = Y - Y.mean()
    _, logdet = np.linalg.slogdet(K)
    return float(-0.5 * (r.T @ np.linalg.solve(K, r)).item() - 0.5 * logdet
                 - 0.5 * len(X) * math.log(2 * math.pi))


def test_state_against_numpy():
    X, Y, theta = data()
    s = gp64.State(torch.tensor(X), torch.tensor(Y), theta, NOISE)
    K = np_train(X, theta)
    Kinv = np.linalg.inv(K)
    np.testing.assert_allclose(s.L.numpy(), np.linalg.cholesky(K),
                               atol=1e-12)
    np.testing.assert_allclose(s.Kinv.numpy(), Kinv, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(s.Linv.numpy(),
                               np.linalg.inv(np.linalg.cholesky(K)),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(s.alpha.numpy(), Kinv @ (Y - Y.mean()),
                               rtol=1e-9, atol=1e-9)
    for m in (1, 7, 40):
        Km = np.linalg.inv(K[:m, :m])
        np.testing.assert_allclose(s.prefix_kinv(m).numpy(), Km,
                                   rtol=1e-9, atol=1e-9)


def test_prefix_posterior_against_each_prefix():
    X, Y, theta = data()
    d = X.shape[1]
    s = gp64.State(torch.tensor(X), torch.tensor(Y), theta, NOISE)
    Q = np.random.default_rng(1).uniform(size=(5, d))
    m = [1, 10, 17, 33, 40]
    Qs = gp64.scaled(torch.tensor(Q), theta[:d])
    mean, var, _ = gp64.prefix_posterior(s.L, s.Xs, torch.tensor(Y), Qs, m,
                                         s.sf2)
    sf2 = math.exp(2 * theta[d])
    for i, mi in enumerate(m):
        K = np_train(X[:mi], theta)
        k = np_cov(X[:mi], Q[i:i + 1], theta)[:, 0]
        ybar = Y[:mi].mean()
        mu = ybar + k @ np.linalg.solve(K, Y[:mi, 0] - ybar)
        v = sf2 - k @ np.linalg.solve(K, k)
        assert float(mean[i]) == pytest.approx(mu, rel=1e-10, abs=1e-12)
        assert float(var[i]) == pytest.approx(v, rel=1e-9, abs=1e-12)


def np_posterior(X, Y, theta, q, m):
    """Mean and variance at one point over the first m rows, solved
    on their own."""
    d = X.shape[1]
    K = np_train(X[:m], theta)
    k = np_cov(X[:m], q[None, :], theta)[:, 0]
    ybar = Y[:m].mean()
    return (ybar + k @ np.linalg.solve(K, Y[:m, 0] - ybar),
            math.exp(2 * theta[d]) - k @ np.linalg.solve(K, k))


def test_posterior_grad_against_differences():
    X, Y, theta = data()
    d = X.shape[1]
    s = gp64.State(torch.tensor(X), torch.tensor(Y), theta, NOISE)
    Q = np.random.default_rng(2).uniform(size=(4, d))
    m = [3, 12, 29, 40]
    Qs = gp64.scaled(torch.tensor(Q), theta[:d])
    mean, var, dmean, dvar, k, c = gp64.prefix_posterior_grad(
        s.L, s.Xs, torch.tensor(Y), Qs, m, s.sf2)
    ell = np.exp(theta[:d])
    h = 1e-6
    for i, mi in enumerate(m):
        mu, v = np_posterior(X, Y, theta, Q[i], mi)
        assert float(mean[i]) == pytest.approx(mu, rel=1e-10, abs=1e-12)
        assert float(var[i]) == pytest.approx(v, rel=1e-9, abs=1e-12)
        assert not k[mi:, i].any() and not c[mi:, i].any()
        for j in range(d):
            e = np.zeros(d)
            e[j] = h
            hi = np_posterior(X, Y, theta, Q[i] + e, mi)
            lo = np_posterior(X, Y, theta, Q[i] - e, mi)
            # the gradients are in the scaled inputs: d/dq = ell d/dx
            for got, a, b in ((dmean, hi[0], lo[0]), (dvar, hi[1], lo[1])):
                fd = ell[j] * (a - b) / (2 * h)
                assert float(got[i, j]) == pytest.approx(fd, rel=1e-5,
                                                         abs=1e-8)


@pytest.mark.parametrize("sigma", [0.1, -0.2])
def test_lml_grad_against_differences(sigma):
    X, Y, theta = data(n=30)
    theta[-1] = sigma
    v, g, vpart, gpart = gp64.lml_grad(torch.tensor(X), torch.tensor(Y),
                                       theta, NOISE, rows=7)
    assert v == pytest.approx(np_lml(X, Y, theta), rel=1e-12)
    h = 1e-5
    for j in range(len(theta)):
        e = np.zeros_like(theta)
        e[j] = h
        fd = (np_lml(X, Y, theta + e) - np_lml(X, Y, theta - e)) / (2 * h)
        assert float(g[j]) == pytest.approx(fd, rel=1e-6, abs=1e-7)
        assert float(gpart[j]) >= abs(float(g[j])) - 1e-12
    assert vpart >= abs(v)


def test_rel_max():
    B = torch.tensor([[2.0, -4.0], [1.0, 0.5]], dtype=torch.float64)
    A = B.clone()
    A[1, 1] += 0.4
    assert gp64.rel_max(A.float(), B, rows=1) == pytest.approx(0.1)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0])
    # 10 explicit mantissa bits: ties to even, then to nearest
    want = torch.tensor([1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10, -3.0])
    assert torch.equal(control.tf32(x), want)
    r = torch.randn(1000)
    rel = ((control.tf32(r) - r).abs() / r.abs()).max()
    assert 2.0 ** -13 < rel <= 2.0 ** -11


def test_fp8_rounding():
    M = torch.randn(50, 50, dtype=torch.float64)
    E = control.fp8(M) - M
    top = float(M.abs().max())
    assert float(E.abs().max()) <= top * 2.0 ** -4
    assert float(E.abs().max()) > top * 2.0 ** -8


def test_control_state_is_tf32_accurate():
    X, Y, theta = data(n=96)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    s = gp64.State(Xt, Yt, theta, NOISE)
    c = control.State(Xt, Yt, theta, NOISE, block=16)
    for got, ref in ((c.L, s.L), (c.Linv, s.Linv), (c.Kinv, s.Kinv),
                     (c.alpha, s.alpha)):
        err = gp64.rel_max(got, ref)
        assert 1e-6 < err < 1e-1
    v, g = control.lml_grad(Xt, Yt, theta, NOISE, rows=40, block=16)
    v64, g64, vpart, gpart = gp64.lml_grad(Xt, Yt, theta, NOISE)
    assert abs(v - v64) / vpart < 1e-2
    assert float(((g - g64).abs() / gpart).max()) < 1e-1
