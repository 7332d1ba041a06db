"""The eigensolver's plain version (limbo_tpu_torch/ops/sym_eig.py, the
rotations and order of csrc/sym_eig.cu) on the CPU, in f64, against
numpy's LAPACK eigh: eigenvalues, V diag(w) V^T, orthogonality, the
eigenvectors where the eigenvalues are apart, and the sort-and-sign rule;
on random, repeated-eigenvalue (a I plus a rank-mu update, as CMA-ES's
covariance at d = 6 with mu = 4) and ill-conditioned (eigenvalues from
1e-12 to 1) matrices, odd and even d from 1 to 32; and the sweep rule."""

import numpy as np
import pytest
import torch

from limbo_tpu_torch.ops import sym_eig as se

torch.set_num_threads(1)

TOL = 1e-12
DS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16, 17, 24, 31, 32)


def _matrices(d: int, seed: int) -> np.ndarray:
    """(4, d, d): a random symmetric matrix, a I plus a rank-mu update
    (mu = min(4, d)), an ill-conditioned covariance (eigenvalues logspaced
    from 1e-12 to 1 in a random basis), and one with a repeated eigenvalue
    in a random basis."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((d, d))
    mu = min(4, d)
    Y = rng.standard_normal((mu, d))
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    ill = (Q * np.logspace(-12, 0, d)) @ Q.T
    lam = np.where(np.arange(d) < d // 2, 0.3, 1.0 + np.arange(d))
    rep = (Q * lam) @ Q.T
    return np.stack([M + M.T, 0.7 * np.eye(d) + 0.1 * Y.T @ Y / mu,
                     (ill + ill.T) / 2, (rep + rep.T) / 2])


def _held(A: np.ndarray, w: torch.Tensor, V: torch.Tensor) -> None:
    w, V = w.numpy(), V.numpy()
    d = A.shape[-1]
    w0, V0 = np.linalg.eigh(A)
    np.testing.assert_allclose(w, w0, rtol=0, atol=TOL)
    np.testing.assert_allclose((V * w[:, None, :]) @ V.transpose(0, 2, 1), A,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(V.transpose(0, 2, 1) @ V,
                               np.broadcast_to(np.eye(d), A.shape), rtol=0,
                               atol=TOL)
    # eigenvectors whose eigenvalue is apart from its neighbours' (1e-2 of
    # the largest), to a sign
    gap = np.diff(w0, axis=-1)
    edge = np.full(A.shape[:-2] + (1,), np.inf)
    sep = np.minimum(np.concatenate([edge, gap], -1),
                     np.concatenate([gap, edge], -1))
    cols = sep >= 1e-2 * np.abs(w0).max(-1, keepdims=True)
    dv = np.where(cols[:, None, :], np.abs(np.abs(V) - np.abs(V0)), 0.0)
    assert dv.max() <= TOL, dv.max()
    # the sign rule: each column's first entry of largest magnitude > 0
    im = np.argmax(np.abs(V), axis=1)
    assert (np.take_along_axis(V, im[:, None, :], 1) > 0).all()


@pytest.mark.parametrize("d", DS)
def test_plain_matches_lapack(d):
    """Every kind of matrix at d, as one batch (each matrix takes its own
    sweeps), against LAPACK; the CPU wrapper is the plain version; the
    sweep rule holds after the sweeps, inside the cap."""
    A = _matrices(d, seed=d)
    At = torch.tensor(A)
    w, V = se.sym_eig_plain(At)
    _held(A, w, V)
    for got, want in zip(se.sym_eig(At), (w, V)):
        assert torch.equal(got, want)
    a, v, sweeps = se.jacobi(At)
    assert (sweeps < se.MAX_SWEEPS).all()
    done, _ = se.sweep_rule(a)
    assert done.all()
    # the rule: off-diagonal mass at most (u ||diag||)^2, u = 2^-53
    off = a.masked_fill(torch.eye(a.shape[-1], dtype=torch.bool), 0.0)
    dg = torch.diagonal(a, dim1=-2, dim2=-1)
    assert (off.square().sum((-2, -1))
            <= (2.0 ** -53) ** 2 * dg.square().sum(-1)).all()
    # zero padding is exact: the padded slots stay zero in a, and v's
    # padded block stays the identity
    D = se.padded_size(d)
    assert torch.equal(a[:, d:, :], torch.zeros_like(a[:, d:, :]))
    assert torch.equal(v[:, d:, :d], torch.zeros_like(v[:, d:, :d]))
    assert torch.equal(v[:, d:, d:], torch.eye(D - d, dtype=v.dtype)
                       .expand(len(A), D - d, D - d))


@pytest.mark.parametrize("D", (2, 4, 6, 8, 16, 32))
def test_schedule_meets_every_pair_once(D):
    """A sweep's D - 1 rounds pair every two slots' contents once, each
    round D / 2 disjoint pairs."""
    seen = []
    for P, Q in se.schedule(D):
        assert len(set(P) | set(Q)) == D
        seen += [tuple(sorted(pq)) for pq in zip(P, Q)]
    assert len(seen) == len(set(seen)) == D * (D - 1) // 2
    assert se.padded_size(D) == D and se.padded_size(D - 1) == D


def test_sweeps_end_by_the_rule_in_f32():
    """In f32 the rule's u is 2^-24: a CMA-ES-like covariance at d = 6
    ends in a few sweeps, its eigenvalues within f32 rounding of f64's;
    an already diagonal matrix takes no sweep, and a repeated eigenvalue
    needs none turned."""
    A = _matrices(6, seed=3)
    a, _, sweeps = se.jacobi(torch.tensor(A, dtype=torch.float32))
    assert (sweeps >= 1).all() and (sweeps <= 6).all()
    w = se.sym_eig_plain(torch.tensor(A, dtype=torch.float32))[0]
    np.testing.assert_allclose(w.double().numpy(), np.linalg.eigvalsh(A),
                               rtol=0, atol=2e-6 * np.abs(A).max())
    diag = torch.diag_embed(torch.tensor([[3.0, 1.0, 2.0], [2.0, 2.0, 2.0]]))
    _, _, sweeps = se.jacobi(diag)
    assert sweeps.tolist() == [0, 0]
    w, V = se.sym_eig_plain(diag)
    assert w.tolist() == [[1.0, 2.0, 3.0], [2.0, 2.0, 2.0]]
    assert torch.equal(V[1], torch.eye(3))        # stable: index order kept
