"""The port's CUDA kernels on the card, at ragged shapes the main path does
not reach (edges of tiles, strips and blocks), against their plain
versions; and the captured BO iteration (bo/graph.py) against the eager
one.  Marked ``cuda``: without a card each test skips with a reason.
Run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import copy

import numpy as np
import pytest
import torch

from limbo_tpu_torch.models import gp as gp_mod
from limbo_tpu_torch.ops import _cuda, chol, gram_pallas, mirror, trimv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("form", sorted(gram_pallas.FORMS))
@pytest.mark.parametrize("n,m,d", [
    (1, 1, 1), (37, 100, 3), (130, 65, 20),
    # one feature chunk of 8 and one past it; rows and columns just over
    # the 128-wide tile, with a row stride that is not a multiple of 4
    # floats (the scalar store path) and one that is
    (129, 257, 8), (257, 129, 9), (129, 260, 8),
    # enough tiles for 128-row tiles (the q = 1024 sweep's kind), ragged
    # on both edges, with 16-byte and with scalar stores
    (1100, 4100, 8), (1029, 4133, 3),
    # the main path's shape at the hp capacity (the ascent's q = 64)
    (64, 16896, 8)])
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


@pytest.mark.parametrize("form", sorted(gram_pallas.FORMS))
@pytest.mark.parametrize("N,n,d", [
    (100, 77, 5), (64, 64, 5), (129, 0, 5),
    (1, 0, 8), (1, 1, 8), (100, 0, 8), (100, 100, 8), (100, 99, 8),
    (129, 129, 8), (129, 128, 8), (256, 256, 8), (256, 129, 8),
    (1000, 0, 8), (1000, 1000, 8), (1000, 385, 8), (1000, 383, 8),
    (1000, 640, 20)])
def test_gram_train_kernel_ragged(dev, form, N, n, d):
    """The padded training covariance against its plain version, with its
    padding rows exactly the identity's and the whole matrix exactly
    symmetric (the kernel writes each off-diagonal tile and its
    transpose)."""
    g = torch.Generator(device=dev).manual_seed(1)
    X = torch.rand((N, d), generator=g, device=dev)
    args = (torch.tensor(1.1, device=dev), torch.tensor(0.7, device=dev),
            torch.tensor(0.02, device=dev), n, form)
    before = _cuda.LAUNCHES["gram_train"]
    k = gram_pallas.gram_train_pallas(X, *args)
    assert _cuda.LAUNCHES["gram_train"] == before + 1
    torch.testing.assert_close(k, gram_pallas.gram_train_plain(X, *args),
                               rtol=2e-5, atol=2e-6)
    assert torch.equal(k[n:], torch.eye(N, device=dev)[n:])
    assert torch.equal(k, k.T)


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


def _block_factors(dev, nb, seed=3):
    """(nb B, nb B) lower-triangular: its diagonal blocks the Cholesky
    factors of random SPD blocks (well conditioned at any nb), its lower
    off-diagonal blocks random."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = chol.TRI_INV_BLOCK
    N = nb * B
    A = torch.randn((nb, B, B), generator=g, device=dev)
    D = torch.linalg.cholesky(A @ A.transpose(1, 2) / B
                              + torch.eye(B, device=dev))
    L = torch.randn((N, N), generator=g, device=dev).tril_()
    _diag(L).copy_(D.permute(1, 2, 0))
    return L


def _diag(L):
    """(B, B, nb) view of the diagonal blocks of L."""
    B = chol.TRI_INV_BLOCK
    nb = L.shape[0] // B
    return L.view(nb, B, nb, B).diagonal(dim1=0, dim2=2)


# the main path's 80 blocks (N = 10240) and the hp path's 132 (N = 16896)
@pytest.mark.parametrize("nb", [1, 3, 80, 132])
def test_tri_inv_panel_kernel(dev, nb):
    L = _block_factors(dev, nb)
    B = chol.TRI_INV_BLOCK
    k = chol._tri_inv_panel(L, B)
    p = chol.tri_inv_panel_plain(L, B)
    torch.testing.assert_close(k, p, rtol=0,
                               atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("nb", [3, 132])
def test_tri_inv_panel_reads_only_the_lower_diagonal_blocks(dev, nb):
    """NaN above the diagonal of every diagonal block and in every
    off-diagonal block: the output is finite and matches the plain
    version, which reads the same entries, as on clean input."""
    L = _block_factors(dev, nb)
    B = chol.TRI_INV_BLOCK
    clean = chol.tri_inv_panel_plain(L, B)
    keep = torch.zeros_like(L, dtype=torch.bool)
    _diag(keep).copy_(torch.ones((B, B), dtype=torch.bool, device=dev)
                      .tril()[..., None].expand(B, B, nb))
    Ln = torch.where(keep, L, torch.full_like(L, float("nan")))
    k = chol._tri_inv_panel(Ln, B)
    assert bool(torch.isfinite(k).all())
    torch.testing.assert_close(k, clean, rtol=0,
                               atol=1e-5 * float(clean.abs().max()))
    assert torch.equal(k, chol._tri_inv_panel(L, B))


@pytest.mark.parametrize("nb", [3, 132])
def test_tri_inv_panel_upper_zero_and_repeatable(dev, nb):
    """The upper triangle of every inverse is +0.0 bit for bit, and two
    launches give the same bits."""
    L = _block_factors(dev, nb)
    k = chol._tri_inv_panel(L)
    upper = torch.triu(torch.ones_like(k[0], dtype=torch.bool), 1)
    assert not bool(k[:, upper].view(torch.int32).any())
    assert torch.equal(k.view(torch.int32),
                       chol._tri_inv_panel(L).view(torch.int32))


@pytest.mark.parametrize("b,r", [(0, 0), (1, 40), (131, 127)])
def test_tri_inv_panel_zero_pivot_stays_in_its_block(dev, b, r):
    """A zero on the diagonal of block b gives inf / NaN in that block's
    inverse only: every other block is bit-equal to the clean run."""
    nb = 132
    L = _block_factors(dev, nb)
    clean = chol._tri_inv_panel(L)
    _diag(L)[r, r, b] = 0.0
    k = chol._tri_inv_panel(L)
    assert not bool(torch.isfinite(k[b]).all())
    others = torch.arange(nb, device=dev) != b
    assert torch.equal(k[others], clean[others])


@pytest.mark.parametrize("q,K,N", [
    (64, 2000, 2000), (37, 1000, 1003), (130, 129, 257),
    # across the tile and slice edges: a single row, one row past the
    # 64-row tile, depths that are not multiples of 16, rows of Kq that are
    # not 16-byte multiples, the main path's N = 10240 at the query's q = 64
    (1, 1000, 1000), (65, 1000, 1003), (65, 129, 1001), (64, 10240, 10240),
    # the hp path's depth
    (64, 16896, 1024),
    # a rank's (N, N / 2) column panel of K^-1 over 2 ranks
    # (parallel/sharded_acq.py), at the ascent's q and the sweep's
    (64, 10240, 5120), (1024, 4096, 2048)])
def test_mirror_mm_on_the_card_sums_in_f32(dev, q, K, N):
    """The bf16 mirror product on the card (the exact-sum kernel) returns
    f32 sums of the exact products of its bf16 operands: within the f32
    rounding of one sum, sqrt(K) 2^-24 sum |terms|, of their f64 product,
    at ragged shapes.  On |ks| @ |Kq|, where nothing cancels, the mean
    signed relative error is below 1e-6 (no bias: the tensor-core GEMM's
    truncation gave -4.5e-5), and a product rounded through bf16 (up to
    2^-9) misses the bound."""
    g = torch.Generator(device=dev).manual_seed(4)
    ks = torch.rand((q, K), generator=g, device=dev) - 0.3
    A = torch.randn((K, N), generator=g, device=dev)
    Kq = A.to(torch.bfloat16)
    for a, b in ((ks, Kq), (ks.abs(), Kq.abs().contiguous())):
        before = _cuda.LAUNCHES["mirror_mm"]
        t = gp_mod._mirror_mm(a, b)
        assert _cuda.LAUNCHES["mirror_mm"] == before + 1
        assert t.dtype == torch.float32 and t.shape == (q, N)
        a64, b64 = a.to(torch.bfloat16).double(), b.double()
        tol = K ** 0.5 * 2.0 ** -24 * (a64.abs() @ b64.abs())
        assert bool(((t.double() - a64 @ b64).abs() <= tol).all())
        assert torch.equal(t, gp_mod._mirror_mm(a, b))   # fixed order
    exact = a64 @ b64
    rel = (t.double() - exact) / exact
    assert abs(float(rel.mean())) < 1e-6
    rounded = (a.to(torch.bfloat16) @ b).double()
    assert bool(((rounded - exact).abs() > tol).any())


@pytest.mark.parametrize("pivot", [0, 31, 32, 40, 127])
def test_panel_factor_nan_from_failed_pivot(dev, pivot):
    """An indefinite block, read from a strided panel, whose pivot fails at
    a sub-block boundary (the kernel factors in 32-wide sub-blocks) or
    inside one: NaN from that pivot on, not clamped, and finite entries
    before it; the plain version gives NaN too."""
    g = torch.Generator(device=dev).manual_seed(10)
    B = chol.PANEL_BLOCK
    A = torch.randn((B, B), generator=g, device=dev)
    panel = torch.zeros((3 * B, 2 * B), device=dev)
    panel[B:2 * B, :B] = A @ A.T / B + torch.eye(B, device=dev)
    D = panel[B:2 * B, :B]                          # row stride 2B
    D[pivot, pivot] = -1.0
    L11, _ = chol._panel_factor_pallas(D)
    assert bool(torch.isfinite(L11[:pivot, :pivot]).all())
    assert bool(torch.isnan(torch.diagonal(L11)[pivot:]).all())
    assert bool(torch.isnan(chol.panel_factor_plain(D.contiguous())[0]).any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panel_factor_kernel(dev, seed):
    """The panel kernel against its plain version (cholesky_ex +
    solve_triangular) on random SPD (128, 128) blocks read from a strided
    panel: |err| <= 1e-4 max|plain| (~13 B 2^-24, two orders of a
    condition-~5 factorization).  Indefinite blocks: the test above."""
    g = torch.Generator(device=dev).manual_seed(5 + seed)
    B = chol.PANEL_BLOCK
    A = torch.randn((B, B), generator=g, device=dev)
    panel = torch.zeros((3 * B, 2 * B), device=dev)
    panel[B:2 * B, :B] = A @ A.T / B + torch.eye(B, device=dev)
    D = panel[B:2 * B, :B]                          # row stride 2B
    before = _cuda.LAUNCHES["panel_factor"]
    L11, V = chol._panel_factor_pallas(D)
    assert _cuda.LAUNCHES["panel_factor"] == before + 1
    Lp, Vp = chol.panel_factor_plain(D.contiguous())
    for k, p in ((L11, Lp), (V, Vp)):
        torch.testing.assert_close(k, p, rtol=0,
                                   atol=1e-4 * float(p.abs().max()))
    assert bool((torch.triu(L11, 1) == 0).all())


def test_cholesky_blocked_ragged_against_cholesky_ex(dev):
    """The blocked factorization on the card at N = 12500 (padded to 12544
    with an identity block), entry by entry: |L L^T - K| <= N 2^-24
    (|L| |L|^T), the componentwise backward error of an f32 Cholesky, with
    the residual formed in f64; and |L - L_ex| <= 1e-4 max|L_ex| against
    torch.linalg.cholesky_ex of the same K.  L rounded through bf16 must
    miss both."""
    g = torch.Generator(device=dev).manual_seed(6)
    N = 12500
    X = torch.rand((N, 8), generator=g, device=dev) / 0.3
    from limbo_tpu_torch.ops import gram_pallas as gp_ops
    K = gp_ops.gram_train_pallas(X, torch.tensor(1.0, device=dev),
                                 torch.ones((), device=dev),
                                 torch.tensor(0.09, device=dev), N, "se")
    before = _cuda.LAUNCHES["panel_factor"]
    L = chol.cholesky(K)
    assert _cuda.LAUNCHES["panel_factor"] == before + 12544 // 128
    assert L.shape == (N, N)
    Lx = torch.linalg.cholesky_ex(K)[0].double()
    gam = N * 2.0 ** -24
    ftol = 1e-4 * float(Lx.abs().max())
    K = K.double()
    for M, ok in ((L.double(), True),
                  (L.to(torch.bfloat16).double(), False)):
        A = M.abs()
        back = bool(((M @ M.T - K).abs() <= gam * (A @ A.T)).all())
        fwd = bool(((M - Lx).abs() <= ftol).all())
        assert (back, fwd) == (ok, ok)


def test_cholesky_pullback_on_the_card(dev):
    """The pullback of the blocked factorization in f32 on the card
    (N = 4224, so tri_inv runs the tri-inv panel kernel) against the f64
    pullback of the same A: |err| <= cond(A)^2 N 2^-24 max|ref|."""
    g = torch.Generator(device=dev).manual_seed(7)
    N = 4224
    M = torch.randn((N, N), generator=g, device=dev, dtype=torch.float64)
    A = M @ M.T / N + torch.eye(N, device=dev, dtype=torch.float64)
    Lbar = torch.randn((N, N), generator=g, device=dev, dtype=torch.float64)
    A32 = A.float().requires_grad_(True)
    before = _cuda.LAUNCHES["tri_inv_panel"]
    chol.cholesky(A32, min_blocked=0).backward(Lbar.float())
    assert _cuda.LAUNCHES["tri_inv_panel"] == before + 1
    A64 = A.clone().requires_grad_(True)
    chol.cholesky(A64).backward(Lbar)
    cond = float(torch.linalg.cond(A))
    tol = cond ** 2 * N * 2.0 ** -24 * float(A64.grad.abs().max())
    assert float((A32.grad.double() - A64.grad).abs().max()) <= tol


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
    with pytest.raises(ValueError, match="block"):
        chol._panel_factor_pallas(torch.eye(64, device=dev))
    with pytest.raises(ValueError, match="float32"):
        chol._panel_factor_pallas(torch.eye(128, device=dev).double())
    with pytest.raises(ValueError, match="bfloat16"):
        mirror.mirror_mm(X, torch.rand((3, 5), device=dev))


def _bowl(x):
    """A smooth objective on [0, 1]^d, maximum 0 at 0.3."""
    return -np.sum((np.asarray(x, dtype=np.float64) - 0.3) ** 2, keepdims=True)


def test_boptimizer_defaults_on_the_card(dev):
    """BOptimizer() at its defaults (capacity 256): every iteration's
    1024-point sweep against the 256 buffered rows is one gram launch, and
    best_value is the best observation."""
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations

    bo = BOptimizer(stop=(MaxIterations(3),))
    before = _cuda.LAUNCHES["gram"]
    st = bo.optimize(_bowl, 6,
                     generator=torch.Generator(device=dev).manual_seed(0))
    assert _cuda.LAUNCHES["gram"] - before >= 3
    assert st.gp.capacity == 256 and st.gp.n == 13 and st.gp.x.is_cuda
    ys = st.gp.y[:13, 0].cpu()
    assert st.best_value == float(ys.max())
    assert bool(((st.gp.x[:13] >= 0) & (st.gp.x[:13] <= 1)).all())


def test_ask_tell_step_reaches_the_gram_kernel(dev):
    """One ask at the defaults launches the gram kernel for its sweep; the
    acquisition value it reports is UCB at the proposal, recomputed on a
    CPU copy of the GP (plain path) within 1e-4."""
    from limbo_tpu_torch import acqui
    from limbo_tpu_torch.bo import BOptimizer

    bo = BOptimizer()
    st = bo.init_state(6, generator=torch.Generator(device=dev).manual_seed(1))
    while st.pending_init:
        x = bo.ask(st)
        bo.tell(st, x, _bowl(x))
    before = _cuda.LAUNCHES["gram"]
    x = bo.ask(st)
    assert _cuda.LAUNCHES["gram"] == before + 1
    assert x.shape == (6,) and np.all((x >= 0) & (x <= 1))
    g = st.gp
    cpu = g.replace(kernel=copy.deepcopy(g.kernel).cpu(),
                    mean=copy.deepcopy(g.mean).cpu(), x=g.x.cpu(),
                    y=g.y.cpu(), L=g.L.cpu(), alpha=g.alpha.cpu(),
                    n_dev=g.n_dev.cpu())
    want = acqui.UCB()(cpu, torch.from_numpy(x)[None, :])[0]
    assert abs(st.last_acqui_value - float(want)) <= 1e-4
    bo.tell(st, x, _bowl(x))
    assert st.iteration == 1 and st.gp.n == 11


# ---------------------------------------------------------------------------
# the captured BO iteration (bo/graph.py)
# ---------------------------------------------------------------------------

def _graph_state(dev, n=4000, capacity=4096, defer_m=4):
    """A fitted SE-ARD + DataMean GP at capacity 4096 (every kernel's size
    switch: trimv from 4096, gram at 64 x 4096 = 512^2) and its cache with
    Linv, a bf16 mirror and deferred appends."""
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.means import DataMean

    g = torch.Generator(device=dev).manual_seed(5)
    X = torch.rand((n, 8), generator=g, device=dev)
    Y = torch.sin(3.0 * X.sum(dim=1, keepdim=True))
    gp = gp_mod.fit(SquaredExpARD.create(dim=8, device=dev),
                    DataMean.create(device=dev), X, Y, capacity=capacity,
                    device=dev)
    return gp, gp_mod.QueryCache.build(gp, with_Linv=True,
                                       qdtype=torch.bfloat16,
                                       defer_m=defer_m)


def _graph_propose(gen):
    """64 restarts x Rprop(3) from a 128-point sweep, on UCB."""
    from limbo_tpu_torch.acqui import UCB
    from limbo_tpu_torch.opt import RandomRestarts, Rprop

    opt = RandomRestarts(sub=Rprop(iterations=3), repeats=64,
                         sweep_samples=128)

    def propose(model, it):
        start = torch.full((8,), 0.5, device=model.x.device)
        return opt(lambda Z: UCB()(model, Z), start, gen, True).x
    return propose


def _graph_objective(x):
    return torch.sin(3.0 * torch.sum(x))[None]


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        if t.is_floating_point() else t


def test_captured_step_equals_eager_bit_for_bit(dev):
    """The same state in two copies and two generators of one seed: ten
    iterations (two flushes of defer_m = 4) captured on one and eager on
    the other leave the same bits everywhere, and the device counts follow
    the host's."""
    from limbo_tpu_torch.bo.graph import BOStep

    steps, xs = [], []
    for eager in (False, True):
        gp, cache = _graph_state(dev)
        gen = torch.Generator(device=dev).manual_seed(9)
        rows = torch.zeros((10, 8), device=dev)
        step = BOStep(gp, cache, _graph_propose(gen), _graph_objective, gen,
                      fast_update="deferred",
                      on_sample=lambda it, x, y, rows=rows: rows.index_copy_(
                          0, it.reshape(1), x[None, :]))
        for _ in range(10):
            step.step(eager=eager)
        steps.append(step)
        xs.append(rows)
    assert steps[0].graphs.graphs is not None
    assert steps[1].graphs.graphs is None
    assert torch.equal(_bits(xs[0]), _bits(xs[1]))
    for name in ("x", "y", "L", "alpha", "n_dev"):
        assert torch.equal(_bits(getattr(steps[0].gp, name)),
                           _bits(getattr(steps[1].gp, name))), name
    for name in ("Kinv", "Linv", "Kinv_q", "P", "ay", "u_ones",
                 "base_n_dev"):
        assert torch.equal(_bits(getattr(steps[0].cache, name)),
                           _bits(getattr(steps[1].cache, name))), name
    gp, cache = steps[0].gp, steps[0].cache
    assert gp.n == 4010 and cache.base_n == 4008
    assert int(gp.n_dev) == 4010 and int(cache.base_n_dev) == 4008


def test_two_replays_draw_different_sweeps(dev):
    """The sweep is drawn before each replay into the graph's buffer: two
    replays see two sweeps, and the draws are the eager run's."""
    from limbo_tpu_torch.bo.graph import BOStep

    gp, cache = _graph_state(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    step = BOStep(gp, cache, _graph_propose(gen), _graph_objective, gen,
                  fast_update="deferred")
    step.step()
    draws = step.graphs.draws
    assert len(draws.buffers) == 1 and draws.buffers[0].shape == (128, 8)
    sweeps = []
    for _ in range(2):
        step.step()
        sweeps.append(draws.buffers[0].clone())
    assert not torch.equal(sweeps[0], sweeps[1])
    g = torch.Generator(device=dev).manual_seed(3)
    want = [torch.rand((128, 8), generator=g, device=dev) for _ in range(3)]
    assert torch.equal(sweeps[0], want[1]) and torch.equal(sweeps[1], want[2])


def test_capture_of_a_step_that_waits_on_the_card_raises(dev):
    """An objective that reads the card (.item()) fails the warm-up under
    the sync check, and the step keeps failing: no eager fallback."""
    from limbo_tpu_torch.bo.graph import BOStep

    gp, cache = _graph_state(dev)
    gen = torch.Generator(device=dev).manual_seed(4)

    def objective(x):
        return torch.tensor([float(torch.sin(3.0 * torch.sum(x)).item())],
                            device=x.device)

    step = BOStep(gp, cache, _graph_propose(gen), objective, gen,
                  fast_update="deferred")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="synchroniz"):
            step.step()
        assert step.graphs.graphs is None
    assert torch.cuda.get_sync_debug_mode() == 0


def test_replays_add_their_graphs_launch_counts(dev):
    """The capture launches nothing and counts nothing; each replay adds
    its graph's counts: per iteration gram 5 (sweep, 3 steps, final), the
    mirror 5 and trimv 2, with or without the flush."""
    from limbo_tpu_torch.bo.graph import BOStep

    gp, cache = _graph_state(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    step = BOStep(gp, cache, _graph_propose(gen), _graph_objective, gen,
                  fast_update="deferred")
    want = {"gram": 5, "mirror_mm": 5, "trimv": 2}
    _cuda.reset_launches()
    step.step()                      # warm-up (an eager iteration), capture
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == want
    assert step.launches() == {False: want, True: want}
    for _ in range(6):
        step.step()
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
        k: 7 * v for k, v in want.items()}


def test_optimize_jit_on_the_card(dev):
    """optimize_jit at the defaults for 4 iterations, by replay: a finite
    GP, four live rows, the sweep's gram launch each iteration."""
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations

    def f(x):
        return -torch.sum((x - 0.3) ** 2).reshape(1)

    before = _cuda.LAUNCHES["gram"]
    st, hist = BOptimizer(stop=(MaxIterations(4),)).optimize_jit(
        f, 6, generator=torch.Generator(device=dev).manual_seed(0))
    assert _cuda.LAUNCHES["gram"] - before == 4
    assert int(hist["effective_iterations"]) == 4 and st.gp.n == 14
    assert bool(torch.isfinite(hist["samples"]).all())
    assert bool(torch.isfinite(st.gp.L).all())
    assert st.best_value == float(hist["best"][-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("d,b", [(1, 1), (2, 64), (3, 7), (4, 1), (5, 64),
                                 (6, 7), (7, 1), (8, 64), (32, 3)])
def test_sym_eig_kernel_ragged(dev, dtype, d, b):
    """The eigensolver kernel against its plain version and numpy's LAPACK
    eigh on ragged d and batch sizes: eigenvalues and B D B^T (f32 to 1e-5
    and f64 to 1e-12 of the matrix's scale, times d for d = 32)."""
    from limbo_tpu_torch.ops.sym_eig import sym_eig, sym_eig_plain

    M = np.random.default_rng(d * 100 + b).standard_normal((b, d, d))
    A = M + M.transpose(0, 2, 1)
    At = torch.tensor(A, dtype=dtype, device=dev)
    before = _cuda.LAUNCHES["sym_eig"]
    w, V = sym_eig(At)
    assert _cuda.LAUNCHES["sym_eig"] == before + 1
    wp, Vp = sym_eig_plain(At)
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * np.abs(A).max() \
        * max(1, d // 8)
    rec = (V @ torch.diag_embed(w) @ V.transpose(-1, -2)).double().cpu()
    np.testing.assert_allclose(w.double().cpu().numpy(),
                               wp.double().cpu().numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(w.double().cpu().numpy(),
                               np.linalg.eigvalsh(A), atol=tol, rtol=0)
    np.testing.assert_allclose(rec.numpy(), A, atol=tol, rtol=0)
    eye = np.broadcast_to(np.eye(d), (b, d, d))
    np.testing.assert_allclose(
        (V.transpose(-1, -2) @ V).double().cpu().numpy(), eye,
        atol=tol / np.abs(A).max(), rtol=0)


def test_sym_eig_refuses_what_the_kernel_does_not_take(dev):
    from limbo_tpu_torch.ops.sym_eig import sym_eig

    with pytest.raises(ValueError, match="1 <= d <= 32"):
        sym_eig(torch.eye(33, device=dev))
    with pytest.raises(ValueError, match="float32 or float64"):
        sym_eig(torch.eye(3, device=dev, dtype=torch.float16))


def _hard_spectra(kind: str, rng) -> np.ndarray:
    """a I plus a rank-4 update at d = 6 (a repeated eigenvalue, as
    CMA-ES's covariance at mu = 4), an ill-conditioned covariance at d = 8
    (eigenvalues from 1e-12 to 1 in a random basis), or 64 random
    symmetric matrices at d = 32."""
    if kind == "repeated":
        Y = rng.standard_normal((5, 4, 6))
        return 0.7 * np.eye(6) + 0.1 * np.swapaxes(Y, 1, 2) @ Y / 4
    if kind == "ill":
        Q = np.linalg.qr(rng.standard_normal((5, 8, 8)))[0]
        A = (Q * np.logspace(-12, 0, 8)[None, None, :]) @ np.swapaxes(Q, 1, 2)
        return (A + np.swapaxes(A, 1, 2)) / 2
    M = rng.standard_normal((64, 32, 32))
    return M + np.swapaxes(M, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["repeated", "ill", "random_d32_b64"])
def test_sym_eig_kernel_hard_spectra(dev, dtype, kind):
    """The eigensolver kernel on a repeated eigenvalue, an ill-conditioned
    covariance and d = 32 at batch 64: eigenvalues against numpy's LAPACK
    eigh and the plain version, V diag(w) V^T, orthogonality and the sign
    rule, within 1e-5 (f32) or 1e-12 (f64) of max|A|, times d / 8 past
    d = 8 (test_sym_eig_kernel_ragged's tolerance)."""
    from limbo_tpu_torch.ops.sym_eig import sym_eig, sym_eig_plain

    A = _hard_spectra(kind, np.random.default_rng(5))
    b, d = A.shape[0], A.shape[-1]
    At = torch.tensor(A, dtype=dtype, device=dev)
    before = _cuda.LAUNCHES["sym_eig"]
    w, V = sym_eig(At)
    assert _cuda.LAUNCHES["sym_eig"] == before + 1
    wp, _ = sym_eig_plain(At)
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * np.abs(A).max() \
        * max(1, d // 8)
    w64, V64 = w.double().cpu().numpy(), V.double().cpu().numpy()
    np.testing.assert_allclose(w64, wp.double().cpu().numpy(), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(w64, np.linalg.eigvalsh(A), atol=tol, rtol=0)
    np.testing.assert_allclose((V64 * w64[:, None, :]) @ np.swapaxes(V64, 1, 2),
                               A, atol=tol, rtol=0)
    np.testing.assert_allclose(np.swapaxes(V64, 1, 2) @ V64,
                               np.broadcast_to(np.eye(d), (b, d, d)),
                               atol=tol / np.abs(A).max(), rtol=0)
    im = np.argmax(np.abs(V64), axis=1)
    assert (np.take_along_axis(V64, im[:, None, :], 1) > 0).all()


def test_sym_eig_captured_replay_equals_eager(dev):
    """sym_eig captured in a CUDA graph (as inside the captured BO
    iteration) gives the eager launch's bits on replay, also after its
    input is rewritten in place."""
    from limbo_tpu_torch.ops.sym_eig import sym_eig

    rng = np.random.default_rng(7)
    A1, A2 = (torch.tensor(_hard_spectra("repeated", rng), device=dev,
                           dtype=torch.float32) for _ in range(2))
    static = A1.clone()
    sym_eig(static)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        w, V = sym_eig(static)
    for A in (A1, A2):
        static.copy_(A)
        g.replay()
        torch.cuda.synchronize()
        w0, V0 = sym_eig(A)
        assert torch.equal(w, w0) and torch.equal(V, V0)
    assert not torch.equal(w0, sym_eig(A1)[0])


def _small_gp(dev):
    from limbo_tpu_torch.kernels import MaternFiveHalves
    from limbo_tpu_torch.means import DataMean

    g = torch.Generator(device=dev).manual_seed(2)
    X = torch.rand((20, 6), generator=g, device=dev)
    return gp_mod.fit(MaternFiveHalves.create(noise=1e-10, device=dev),
                      DataMean.create(device=dev), X,
                      _tbowl(X)[:, None], capacity=256, device=dev)


def _tbowl(X):
    """_bowl as torch code on the device, over the last axis."""
    return -torch.sum((X - 0.3) ** 2, dim=-1)


@pytest.mark.parametrize("name", ["cmaes", "direct"])
def test_cmaes_direct_captured_equal_eager_bit_for_bit(dev, name):
    """CMA-ES (restarts 2, with its eigensolver kernel) and DIRECT-L as the
    acquisition optimizer of a captured BO iteration: four iterations by
    replay give the eager run's bits (proposals and GP), the warm-up under
    set_sync_debug_mode("error") stays silent, and eagerly both optimizers
    run under it too."""
    from limbo_tpu_torch.acqui import UCB
    from limbo_tpu_torch.bo.graph import BOStep
    from limbo_tpu_torch.opt import Cmaes, DirectL

    opt = (Cmaes(iterations=6, pop_size=8, restarts=2) if name == "cmaes"
           else DirectL(rounds=5, splits_per_round=4))

    def propose_with(gen):
        def propose(model, it):
            start = torch.full((6,), 0.5, device=dev)
            return opt(lambda Z: UCB(0.125)(model, Z), start, gen, True).x
        return propose

    gen = torch.Generator(device=dev).manual_seed(1)
    gp = _small_gp(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        propose_with(gen)(gp, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps, rows = [], []
    for eager in (False, True):
        gen = torch.Generator(device=dev).manual_seed(8)
        xs = torch.zeros((4, 6), device=dev)
        step = BOStep(_small_gp(dev), None, propose_with(gen),
                      lambda x: _tbowl(x).reshape(1), gen,
                      on_sample=lambda it, x, y, xs=xs: xs.index_copy_(
                          0, it.reshape(1), x[None, :]))
        before = _cuda.LAUNCHES["sym_eig"]
        for _ in range(4):
            step.step(eager=eager)
        launched = _cuda.LAUNCHES["sym_eig"] - before
        assert launched == (4 * 6 if name == "cmaes" else 0)
        steps.append(step)
        rows.append(xs)
    assert steps[0].graphs.graphs is not None
    assert torch.equal(_bits(rows[0]), _bits(rows[1]))
    for field in ("x", "y", "L", "alpha", "n_dev"):
        assert torch.equal(_bits(getattr(steps[0].gp, field)),
                           _bits(getattr(steps[1].gp, field))), field
    assert steps[0].gp.n == 24 and bool(torch.isfinite(rows[0]).all())


def test_capture_survives_a_garbage_graph(dev):
    """An earlier step, captured and dropped, waits in a reference cycle
    for the cyclic collector; a later capture whose step allocates many
    Python objects (so that a collection would start during it) must not
    destroy that graph mid-capture: the later run replays, and the
    collector is on again afterwards."""
    import gc

    from limbo_tpu_torch.bo.graph import BOStep

    def objective(x):
        junk = [[i] for i in range(200000)]      # Python allocations
        del junk
        return _tbowl(x).reshape(1)

    def propose_with(gen):
        from limbo_tpu_torch.acqui import UCB
        from limbo_tpu_torch.opt import RandomRestarts, Rprop

        opt = RandomRestarts(sub=Rprop(iterations=2), repeats=8,
                             sweep_samples=16)
        return lambda model, it: opt(lambda Z: UCB()(model, Z),
                                     torch.full((6,), 0.5, device=dev),
                                     gen, True).x

    gc.collect()
    for seed in range(3):
        gen = torch.Generator(device=dev).manual_seed(seed)
        step = BOStep(_small_gp(dev), None, propose_with(gen), objective,
                      gen)
        for _ in range(3):
            step.step()
        assert step.graphs.graphs is not None and step.gp.n == 23
        del step                          # its graph now waits in a cycle
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# slice 9: the lite mirror, its captured flush, the CG solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1000, 4100, 1283])
def test_mirror_from_linv_ragged_on_the_card(dev, N):
    """The panel-by-panel bf16 mirror (one panel at 1000, five of 820 at
    4100, 1283 of width 1 at a prime N) against the plain f32 product cast
    once, within one bf16 step, 2^-7 relative (the panels skip Linv's zero
    rows, so their f32 sums may round to the neighbouring bf16 value),
    written in place."""
    g = torch.Generator(device=dev).manual_seed(3)
    A = torch.rand((N, N), generator=g, device=dev) / N
    Linv = torch.tril(A) + torch.eye(N, device=dev)
    plain = (Linv.T @ Linv).to(torch.bfloat16).double()
    out = torch.full((N, N), float("nan"), dtype=torch.bfloat16, device=dev)
    got = gp_mod._mirror_from_linv(Linv, torch.bfloat16, out=out)
    assert got is out
    assert bool((got.double() - plain).abs().le(
        2.0 ** -7 * plain.abs()).all())


def test_lite_flush_captured_equals_eager(dev):
    """A lite cache (Linv, bf16 mirror from Linv, defer_m = 4) at capacity
    4096: eight iterations (two flushes, each rebuilding the mirror panel
    by panel inside the flush graph, the last at the last iteration)
    captured on one copy and eager on the other leave the same bits
    everywhere, and the mirror is the one rebuilt from the final Linv."""
    from limbo_tpu_torch.bo.graph import BOStep

    steps = []
    for eager in (False, True):
        gp, _ = _graph_state(dev)
        cache = gp_mod.QueryCache.build(gp, with_Linv=True,
                                        qdtype=torch.bfloat16, defer_m=4,
                                        lite=True)
        assert cache.Kinv is None
        gen = torch.Generator(device=dev).manual_seed(9)
        step = BOStep(gp, cache, _graph_propose(gen), _graph_objective, gen,
                      fast_update="deferred")
        for _ in range(8):
            step.step(eager=eager)
        steps.append(step)
    assert steps[0].graphs.graphs is not None
    for name in ("x", "y", "L", "alpha", "n_dev"):
        assert torch.equal(_bits(getattr(steps[0].gp, name)),
                           _bits(getattr(steps[1].gp, name))), name
    for name in ("Linv", "Kinv_q", "P", "ay", "u_ones", "base_n_dev"):
        assert torch.equal(_bits(getattr(steps[0].cache, name)),
                           _bits(getattr(steps[1].cache, name))), name
    c = steps[0].cache
    assert c.Kinv is None and c.base_n == steps[0].gp.n == 4008
    mirror = gp_mod._mirror_from_linv(c.Linv, torch.bfloat16)
    assert torch.equal(_bits(mirror), _bits(c.Kinv_q))


def test_cg_solve_on_the_card_against_f64(dev):
    """cg_solve over the blocked kernel matvec at n = 4096 (block 2048: the
    gram kernel on every row block), four right-hand sides: converged, its
    f64 residual within 1e-4 |b|, and its gradient in B (one more CG solve)
    against K^-1 w in f64 to 1e-3."""
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.models import iterative

    g = torch.Generator(device=dev).manual_seed(4)
    n = 4096
    X = torch.rand((n, 8), generator=g, device=dev)
    k = SquaredExpARD.create(dim=8, noise=0.1, device=dev).replace(
        log_ell=torch.full((8,), -1.0, device=dev))
    mask = torch.ones(n, device=dev)
    B = torch.randn((n, 4), generator=g, device=dev).requires_grad_(True)
    w = torch.randn((n, 4), generator=g, device=dev)

    def mv(V):
        return iterative.blocked_kernel_matvec(k, X, mask, k.noise, V, 2048)

    before = _cuda.LAUNCHES["gram"]
    Xs, r = iterative.cg_solve(mv, B, 1e-6, 500)
    assert _cuda.LAUNCHES["gram"] - before >= 2
    assert bool((r <= 1e-6 * B.detach().norm(dim=0)).all())
    k64 = copy.deepcopy(k).to(torch.float64)
    K = k64.gram(X.double(), X.double())
    K.diagonal().add_(float(k.noise) + 1e-8)
    res = K @ Xs.detach().double() - B.detach().double()
    assert bool((res.norm(dim=0) <= 1e-4 * B.detach().double().norm(dim=0)
                 ).all())
    (gB,) = torch.autograd.grad(torch.sum(w * Xs), B)
    want = torch.linalg.solve(K, w.double())
    assert float((gB.double() - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


# ---------------------------------------------------------------------------
# the multi-objective ops on the card (slice 10): ragged and padded fronts
# ---------------------------------------------------------------------------

def _mo_front(g, k, p, pad, dev):
    """k random non-dominated points (maximization, above -0.2), the first
    duplicated, then `pad` padded rows of garbage; (front, mask)."""
    Y = torch.rand((4 * k + 8, p), generator=g, dtype=torch.float64,
                   device=dev)
    Y = Y / Y.norm(dim=1, keepdim=True)               # on the sphere: a front
    F = Y[:k].clone()
    if k > 1:
        F[1] = F[0]
    F = torch.cat([F, 2.0 + torch.rand((pad, p), generator=g,
                                       dtype=torch.float64, device=dev)])
    m = torch.cat([torch.ones(k, dtype=torch.float64, device=dev),
                   torch.zeros(pad, dtype=torch.float64, device=dev)])
    return F, m


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("k,pad", [(1, 0), (7, 3), (63, 1), (64, 0),
                                   (33, 31)])
def test_mo_ops_on_the_card_equal_cpu(dev, p, k, pad):
    """Pareto masks exactly, the 2-D hypervolume, exact EHVI with its
    autograd gradient and the joint q-EHVI (q = 2, gh 8) for 64 candidates
    on the card against the same calls on the CPU, in f64 (1e-12 relative;
    the card's erfc and sums may round apart)."""
    from limbo_tpu_torch.ops import ehvi, pareto

    g = torch.Generator(device=dev).manual_seed(k + 100 * p)
    F, m = _mo_front(g, k, p, pad, dev)
    ref = torch.full((p,), -0.2, dtype=torch.float64, device=dev)
    mu = torch.rand((64, p), generator=g, dtype=torch.float64, device=dev)
    sg = 0.05 + 0.3 * torch.rand((64, p), generator=g, dtype=torch.float64,
                                 device=dev)
    Y = torch.round(torch.rand((200, p), generator=g, dtype=torch.float64,
                               device=dev), decimals=1)
    assert torch.equal(pareto.non_dominated_mask(Y).cpu(),
                       pareto.non_dominated_mask(Y.cpu()))
    assert torch.equal(pareto.non_dominated_mask(F, m).cpu(),
                       pareto.non_dominated_mask(F.cpu(), m.cpu()))
    if p == 2:
        torch.testing.assert_close(pareto.hypervolume_2d(Y, ref).cpu(),
                                   pareto.hypervolume_2d(Y.cpu(), ref.cpu()),
                                   rtol=1e-12, atol=0)

    def run(mu, sg, F, m, ref):
        mu = mu.clone().requires_grad_(True)
        v = ehvi.ehvi_max(mu, sg, F, ref, m)
        (gm,) = torch.autograd.grad(v.sum(), mu)
        cov = torch.diag_embed(sg.T[:, :2] ** 2)[None].expand(32, p, 2, 2)
        qv = ehvi.qehvi_exact_max(mu.detach().reshape(32, 2, p), cov, F, ref,
                                  m, gh_nodes=8)
        return v.detach(), gm, qv

    for a, b in zip(run(mu, sg, F, m, ref),
                    run(mu.cpu(), sg.cpu(), F.cpu(), m.cpu(), ref.cpu())):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-12, atol=1e-15)
