"""Batched symmetric eigendecomposition of small matrices with no host
read-back (the port's own kernel; the reference's CMA-ES calls
``jnp.linalg.eigh``, limbo_tpu/opt/cmaes.py:93, and leaves it to XLA).

CMA-ES decomposes its (restarts, d, d) covariances every generation, inside
the captured BO iteration (bo/graph.py).  ``torch.linalg.eigh`` on a CUDA
tensor checks its solver's ``info`` on the host, which a capture cannot do,
so the card runs ``csrc/sym_eig.cu``: parallel-ordered Jacobi, the matrix
held a row a lane in registers, sweeps until the off-diagonal mass is below
the working type's rounding of the diagonal.  ``sym_eig_plain`` does the
same rotations in the same order with PyTorch operations; the CPU takes it.

The algorithm (both versions).  A d x d matrix is zero-padded to D slots
(``padded_size``): d rounded up to even for d <= 8, else 16 or 32.  Zero
padding is exact: a padded row and column stay zero, and a pair whose
a_pq is zero gets t = 0, the identity.  A sweep is D - 1 rounds of the
round-robin (circle) ordering (``schedule``): each round turns D / 2
disjoint pairs (p, q) at once, every pair's rotation computed from the
matrix as it was at the start of the round,

    phi = (a_qq - a_pp) / 2,
    t = sign(phi a_pq) |a_pq| / (|phi| + hypot(phi, a_pq))   (0 if a_pq = 0),
    c = rsqrt(1 + t^2), s = t c,

then the columns of A and V turned by every pair, then the rows of A, then
a_pp -= t a_pq, a_qq += t a_pq, a_pq = a_qp = 0.  Before each sweep a
matrix whose off-diagonal mass sum_{i != j} a_ij^2 is at most
(u ||diag(A)||)^2 (u the working type's unit roundoff; the sums in f64) is
done: from then on it is left as it is, so each matrix takes the sweeps it
needs, at most ``MAX_SWEEPS``.  By Weyl's inequality its eigenvalues are
then within u ||diag(A)|| of its diagonal.  In a sweep a pair whose
|a_pq| is at most u ||diag(A)|| (at the sweep's start) is not turned, its
a_pq only set to zero: at rounding level a_pq would otherwise turn a
repeated eigenvalue's pair by 45 degrees each sweep, and the sweeps would
converge linearly (a I plus a rank-4 update at d >= 7 ran to the cap).

The result is normalized so that two solvers agree: eigenvalues ascending
(a stable sort; padded slots dropped by index), and each eigenvector's
first entry of largest magnitude positive.
"""

from __future__ import annotations

import functools

import torch

from limbo_tpu_torch.ops import _cuda

# The cap on sweeps, a bound on the loop and not the rule that ends it:
# the rule ends the random, repeated-eigenvalue and ill-conditioned
# matrices of tests/test_torch_sym_eig.py within 6 sweeps at d <= 8 and 12
# at d = 32 in f64 (eigenvalues from 1e-12 to 1, where Jacobi converges
# only linearly until the off-diagonal mass falls under the small gaps;
# other draws of that spectrum took 16)
MAX_SWEEPS = 20
MAX_D = 32
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def padded_size(d: int) -> int:
    """The slots D a d x d matrix is padded to (csrc/sym_eig.cu's template
    sizes): d rounded up to even up to 8, then 16 or 32."""
    if d <= 8:
        return d + (d & 1)
    return 16 if d <= 16 else 32


def _sigma(s: int, D: int) -> int:
    """Where the content of slot s goes after a round: the circle method
    with slots (2k, 2k+1) the k-th pair, slot 0 fixed and the other D - 1
    slots turning one place (csrc/sym_eig.cu's ``sigma``)."""
    if D == 2 or s == 0:
        return s
    if s % 2 == 0:
        return s + 2 if s < D - 2 else D - 1
    return s - 2 if s > 1 else 2


@functools.lru_cache(maxsize=None)
def schedule(D: int):
    """The D - 1 rounds of one sweep: for each round, the indices at the
    even slots (each pair's p) and at the odd slots (its q).  Every pair of
    indices meets once a sweep, and the slots come back after it."""
    idx, rounds = list(range(D)), []
    for _ in range(D - 1):
        rounds.append((tuple(idx[0::2]), tuple(idx[1::2])))
        new = [0] * D
        for s in range(D):
            new[_sigma(s, D)] = idx[s]
        idx = new
    assert idx == list(range(D))
    return tuple(rounds)


def sweep_rule(a: torch.Tensor):
    """The rule checked before each sweep of a batch (B, D, D): whether a
    matrix is done, its off-diagonal mass at most (u ||diag||)^2 (u the
    unit roundoff of a's type, the sums in f64), and the sweep's threshold
    u ||diag|| in a's type, under which a pair is not turned but its a_pq
    set to zero.  Returns (done (B,) bool, tau (B,))."""
    sq = a.double().square()
    eye = torch.eye(a.shape[-1], dtype=torch.bool, device=a.device)
    off2 = sq.masked_fill(eye, 0.0).sum((-2, -1))
    dg2 = torch.diagonal(sq, dim1=-2, dim2=-1).sum(-1)
    u = UNIT_ROUNDOFF[a.dtype]
    tau = u * torch.sqrt(dg2)
    return off2 <= (u * u) * dg2, tau.to(a.dtype)


def _round(a, v, P, Q, active, tau) -> None:
    """One round in place: the pairs (P[k], Q[k]) turned at once, in the
    kernel's order (columns of a and v, rows of a, the pairs' entries);
    matrices not `active` are left as they are (t = 0, no fix)."""
    app, aqq, apq = a[:, P, P], a[:, Q, Q], a[:, P, Q]
    phi = 0.5 * (aqq - app)
    num = torch.where(phi * apq >= 0, apq.abs(), -apq.abs())
    t = num / (phi.abs() + torch.hypot(phi, apq))
    t = torch.where((apq.abs() > tau[:, None]) & active[:, None], t, 0.0)
    c = torch.rsqrt(1.0 + t * t)
    s = t * c
    cc, sc = c[:, None, :], s[:, None, :]
    for m in (a, v):
        mp, mq = m[:, :, P], m[:, :, Q]
        m[:, :, P] = cc * mp - sc * mq
        m[:, :, Q] = sc * mp + cc * mq
    cr, sr = c[..., None], s[..., None]
    ap, aq = a[:, P, :], a[:, Q, :]
    a[:, P, :] = cr * ap - sr * aq
    a[:, Q, :] = sr * ap + cr * aq
    tapq = t * apq
    on = active[:, None]
    a[:, P, P] = torch.where(on, app - tapq, a[:, P, P])
    a[:, Q, Q] = torch.where(on, aqq + tapq, a[:, Q, Q])
    a[:, P, Q] = torch.where(on, 0.0, a[:, P, Q])
    a[:, Q, P] = torch.where(on, 0.0, a[:, Q, P])


def jacobi(A: torch.Tensor):
    """The sweeps of the plain version on a batch (B, d, d): returns the
    padded (a, v) after them (a nearly diagonal, A = V a V^T on the first d
    slots) and each matrix's sweep count (B,)."""
    B, d = A.shape[0], A.shape[-1]
    D = padded_size(d)
    a = A.new_zeros((B, D, D))
    a[:, :d, :d] = A
    v = torch.eye(D, dtype=A.dtype, device=A.device).expand(B, D,
                                                           D).clone()
    sweeps = torch.zeros(B, dtype=torch.int64, device=A.device)
    rounds = [(torch.tensor(P, device=A.device),
               torch.tensor(Q, device=A.device)) for P, Q in schedule(D)]
    for sweep in range(MAX_SWEEPS + 1):
        done, tau = sweep_rule(a)
        active = ~done
        if sweep == MAX_SWEEPS or not bool(active.any()):
            break
        sweeps += active
        for P, Q in rounds:
            _round(a, v, P, Q, active, tau)
    return a, v, sweeps


def _normalize(w: torch.Tensor, V: torch.Tensor):
    """Sort (w, V) ascending (stable) and make each column's first entry of
    largest magnitude positive."""
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand_as(V))
    im = torch.argmax(V.abs(), dim=-2, keepdim=True)
    sg = torch.where(torch.gather(V, -2, im) < 0, -1.0, 1.0).to(V.dtype)
    return w, V * sg


def sym_eig_plain(A: torch.Tensor):
    """Plain version of the kernel: (..., d, d) symmetric -> (w (..., d)
    ascending, V (..., d, d)) with A = V diag(w) V^T, by the kernel's
    rotations in the kernel's order (see the module docstring)."""
    d = A.shape[-1]
    a, v, _ = jacobi(A.reshape(-1, d, d))
    w = torch.diagonal(a, dim1=-2, dim2=-1)[:, :d]
    w, V = _normalize(w, v[:, :d, :d])
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def sym_eig(A: torch.Tensor):
    """(w, V) of a batch of symmetric matrices (..., d, d), d <= 32, f32 or
    f64: w ascending, A = V diag(w) V^T (see the module docstring).

    CUDA kernel: ``csrc/sym_eig.cu`` sym_eig_launch, replacing the
    ``jnp.linalg.eigh`` of limbo_tpu/opt/cmaes.py:93.  Bound by its chain of
    dependent rounds (latency), not by bytes or operations."""
    if A.device.type != "cuda":
        return sym_eig_plain(A)
    d = A.shape[-1]
    if A.ndim < 2 or A.shape[-2] != d or not 1 <= d <= MAX_D:
        raise ValueError(f"sym_eig: shape {tuple(A.shape)}, needs (..., d, "
                         f"d) with 1 <= d <= {MAX_D}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sym_eig: expected float32 or float64, got "
                         f"{A.dtype}")
    a = A.contiguous()
    batch = a.numel() // (d * d)
    w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty(A.shape, dtype=A.dtype, device=A.device)
    if batch:
        _cuda.launch("sym_eig", "sym_eig_launch", "sym_eig", A.device,
                     a.data_ptr(), batch, d, MAX_SWEEPS,
                     int(A.dtype == torch.float64), w.data_ptr(),
                     V.data_ptr(), None)
    return w, V
