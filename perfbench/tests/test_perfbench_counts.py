"""The closed forms of perfbench/counts/flops.py against brute-force counts
at tiny sizes: the naive algorithms' multiply-adds counted one by one, and
the products of a plain query counted by torch's FLOP counter."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import flops

SIZES = range(1, 9)


def macs_cholesky(n):
    c = 0
    for j in range(n):
        c += j                      # the diagonal: sum of j squares
        for _ in range(j + 1, n):
            c += j                  # an entry below: j products
    return 2 * c


def macs_tri_inv(n):
    c = 0
    for col in range(n):
        for i in range(col + 1, n):
            c += i - col            # sum_{k=col}^{i-1} L_ik v_k
    return 2 * c


def macs_tri_gram(n):
    c = 0
    for i in range(n):
        for j in range(i + 1):
            c += n - i              # sum over rows k >= i of V_ki V_kj
    return 2 * c


def macs_trimv(n):
    return 2 * sum(i + 1 for i in range(n))


def macs_tri_solve(n, k):
    return 2 * k * sum(i for i in range(n))


@pytest.mark.parametrize("n", SIZES)
def test_triangle_counts(n):
    assert flops.cholesky(n) == macs_cholesky(n)
    assert flops.tri_inv(n) == macs_tri_inv(n)
    assert flops.tri_gram(n) == macs_tri_gram(n)
    assert flops.trimv(n) == macs_trimv(n)
    assert flops.tri_solve(n, 2) == macs_tri_solve(n, 2)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("q,n,d,p", [(1, 5, 2, 0), (4, 7, 3, 2),
                                     (3, 6, 8, 5)])
def test_query_count(q, n, d, p):
    Q, X = torch.rand(q, d), torch.rand(n, d)
    alpha, M, P = torch.rand(n, 1), torch.rand(n, n), torch.rand(n, p)

    def query():
        ks = Q @ X.T                # the distances' product
        ks @ alpha                  # the mean
        ks @ M                      # the mirror product
        (ks @ P) @ P.T              # the pending correction

    assert flops.query(q, n, d, p) == counted(query)
    assert flops.gram(q, n, d) == counted(lambda: Q @ X.T)

    def backward():
        g = torch.rand(q, n)
        g @ X                       # the distances' product, backward
        g @ alpha                   # the mean's

    assert flops.query_grad(q, n, d) == counted(backward)


@pytest.mark.parametrize("n,m", [(5, 2), (8, 3)])
def test_flush_count(n, m):
    K, P = torch.rand(n, n), torch.rand(n, m)
    rhs = torch.rand(n, 2)
    assert flops.flush(n, m, lite=False) == counted(
        lambda: (P @ P.T, K @ rhs))
    assert flops.flush(n, m, lite=True) == (macs_tri_gram(n)
                                            + 4 * macs_trimv(n))


def test_bo_iteration_sums_its_parts():
    n, d, r, s, q, p = 9, 3, 4, 2, 6, 1
    want = (flops.query(q, n, d, p)
            + s * (flops.query(r, n, d, p) + flops.query_grad(r, n, d))
            + flops.query(r, n, d, p) + 2 * n * d + 2 * macs_trimv(n))
    assert flops.bo_iteration(n, d, r, s, q, p) == want
    assert (flops.bo_iteration(n, d, r, s, q, p, True, 4, False)
            == want + flops.flush(n + 1, 4, False))


@pytest.mark.parametrize("n,d", [(4, 2), (7, 3)])
def test_lml_and_refit_counts(n, d):
    base = n * (n + 1) * d + macs_cholesky(n) + macs_tri_solve(n, 2)
    assert flops.lml(n, d) == base
    assert flops.lml_grad(n, d) == (base + macs_tri_inv(n)
                                    + macs_tri_gram(n) + 2 * (d + 1) * n * n)
    assert flops.refit(n, d) == (base + macs_tri_inv(n) + macs_tri_gram(n)
                                 + 4 * macs_trimv(n))
    # the training covariance's lower half with its diagonal
    assert flops.gram_train(n, d) == 2 * d * sum(i + 1 for i in range(n))


def test_mirror_bound():
    q, N = 64, 16896
    by = flops.mirror_mm_bytes(q, N, N)
    assert by == 2 * N * N + 4 * q * N + 4 * q * N
    # bound by the bytes at q = 64, by the operations at q = 1024
    b64 = flops.bound_s(by, flops.mirror_mm_ops(q, N, N), flops.PEAK_BF16)
    assert b64 == pytest.approx(by / flops.HBM_BYTES_PER_S)
    ops = flops.mirror_mm_ops(1024, N, N)
    b1k = flops.bound_s(flops.mirror_mm_bytes(1024, N, N), ops,
                        flops.PEAK_BF16)
    assert b1k == pytest.approx(ops / flops.PEAK_BF16)
