"""The port's CUDA kernels on the card, at ragged shapes the main path does
not reach (edges of tiles, strips and blocks), against their plain
versions.  Marked ``cuda``: without a card each test skips with a reason.
Run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.ops import _cuda, chol, gram_pallas, trimv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("form", sorted(gram_pallas.FORMS))
@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (37, 100, 3), (130, 65, 20)])
def test_gram_kernel_ragged(dev, form, n, m, d):
    g = torch.Generator(device=dev).manual_seed(0)
    X1 = torch.rand((n, d), generator=g, device=dev)
    X2 = torch.rand((m, d), generator=g, device=dev)
    sf2, inv_l = torch.tensor(1.3, device=dev), torch.tensor(0.9, device=dev)
    before = _cuda.LAUNCHES["gram"]
    k = gram_pallas.gram_pallas(X1, X2, sf2, inv_l, form)
    assert _cuda.LAUNCHES["gram"] == before + 1
    p = gram_pallas.gram_plain(X1, X2, sf2, inv_l, form)
    torch.testing.assert_close(k, p, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("N,n", [(100, 77), (64, 64), (129, 0)])
def test_gram_train_kernel_ragged(dev, N, n):
    g = torch.Generator(device=dev).manual_seed(1)
    X = torch.rand((N, 5), generator=g, device=dev)
    args = (torch.tensor(1.1, device=dev), torch.tensor(0.7, device=dev),
            torch.tensor(0.02, device=dev), n, "matern52")
    k = gram_pallas.gram_train_pallas(X, *args)
    torch.testing.assert_close(k, gram_pallas.gram_train_plain(X, *args),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("N", [1, 31, 1000])
@pytest.mark.parametrize("transpose", [False, True])
def test_trimv_kernel_ragged(dev, N, transpose):
    g = torch.Generator(device=dev).manual_seed(2)
    L = torch.randn((N, N), generator=g, device=dev)   # upper part ignored
    v = torch.randn((N,), generator=g, device=dev)
    k = trimv._trimv_pallas(L, v, transpose)
    p = trimv.trimv_plain(L, v, transpose)
    A = torch.tril(L).abs()
    tol = 1e-5 * ((A.T if transpose else A) @ v.abs())
    assert bool(((k - p).abs() <= tol + 1e-6).all())
    # deterministic: the same bits every run
    assert torch.equal(k, trimv._trimv_pallas(L, v, transpose))


@pytest.mark.parametrize("nb", [1, 3])
def test_tri_inv_panel_kernel(dev, nb):
    g = torch.Generator(device=dev).manual_seed(3)
    B = chol.TRI_INV_BLOCK
    N = nb * B
    A = torch.randn((N, N), generator=g, device=dev)
    L = torch.linalg.cholesky(A @ A.T / N + torch.eye(N, device=dev))
    L = L.contiguous()
    k = chol._tri_inv_panel(L, B)
    p = chol.tri_inv_panel_plain(L, B)
    torch.testing.assert_close(k, p, rtol=0,
                               atol=1e-5 * float(p.abs().max()))


def test_mirror_mm_on_the_card_sums_in_f32(dev):
    """The bf16 mirror product on the card (the mixed-dtype GEMM) returns
    f32 sums of the exact products of its bf16 operands: within 2^-11 of
    sum |terms| of their f64 product.  The card's GEMM truncates as it
    accumulates (a bias toward 0 that grows with the depth), so the bound
    is not the f32 rounding of one sum.  On positive operands a result
    rounded through bf16 (up to 2^-9) misses it."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, K = 64, 2000
    ks = torch.rand((q, K), generator=g, device=dev) - 0.3
    A = torch.randn((K, K), generator=g, device=dev)
    Kq = (A + A.T).to(torch.bfloat16)
    for a, b in ((ks, Kq), (ks.abs(), Kq.abs())):
        t = gp_mod._mirror_mm(a, b)
        assert t.dtype == torch.float32
        a64, b64 = a.to(torch.bfloat16).double(), b.double()
        tol = 2.0 ** -11 * (a64.abs() @ b64.abs())
        assert bool(((t.double() - a64 @ b64).abs() <= tol).all())
    rounded = (a.to(torch.bfloat16) @ b).double()
    assert bool(((rounded - a64 @ b64).abs() > tol).any())


def test_use_pallas_rule(dev):
    """The card, f32, n * m >= 512^2: the reference's threshold."""
    big, one = torch.rand((64, 8), device=dev), torch.rand((1, 8), device=dev)
    X = torch.rand((10240, 8), device=dev)
    assert gram_pallas.use_pallas(big, X)
    assert not gram_pallas.use_pallas(one, X)
    assert not gram_pallas.use_pallas(big.double(), X.double())
    assert not gram_pallas.use_pallas(big.cpu(), X.cpu())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    X = torch.rand((8, 3), device=dev)
    one = torch.tensor(1.0, device=dev)
    with pytest.raises(ValueError, match="float32"):
        gram_pallas.gram_pallas(X.double(), X.double(), one, one)
    with pytest.raises(ValueError, match="contiguous"):
        trimv._trimv_pallas(torch.rand((8, 8), device=dev).T,
                            torch.rand((8,), device=dev))
    with pytest.raises(ValueError, match="block"):
        chol._tri_inv_panel(torch.eye(96, device=dev), 48)
