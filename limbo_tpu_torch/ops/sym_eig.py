"""Batched symmetric eigendecomposition of small matrices with no host
read-back (the port's own kernel; the reference's CMA-ES calls
``jnp.linalg.eigh``, limbo_tpu/opt/cmaes.py:93, and leaves it to XLA).

CMA-ES decomposes its (restarts, d, d) covariances every generation, inside
the captured BO iteration (bo/graph.py).  ``torch.linalg.eigh`` on a CUDA
tensor checks its solver's ``info`` on the host, which a capture cannot do,
so the card runs ``csrc/sym_eig.cu``: cyclic Jacobi with a fixed number of
sweeps, one warp a matrix.  ``sym_eig_plain`` does the same rotations in the
same order with PyTorch operations; the CPU takes it.

The result is normalized so that two solvers agree: eigenvalues ascending
(as LAPACK's), and each eigenvector's first entry of largest magnitude
positive.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.ops import _cuda

# Cyclic Jacobi converges quadratically: at d <= 8 five sweeps take a
# random symmetric matrix's off-diagonal mass to f64 rounding; 10 leave
# room for d up to 32 (MAXD in csrc/sym_eig.cu).
SWEEPS = 10
MAX_D = 32


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
    rotations in the kernel's order."""
    d = A.shape[-1]
    a = A.reshape(-1, d, d).clone()
    v = torch.eye(d, dtype=A.dtype, device=A.device).expand_as(a).clone()
    for _ in range(SWEEPS):
        for p in range(d - 1):
            for q in range(p + 1, d):
                apq = a[:, p, q].clone()
                app = a[:, p, p].clone()
                aqq = a[:, q, q].clone()
                zero = apq == 0
                theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
                sgn = torch.where(theta >= 0, 1.0, -1.0).to(A.dtype)
                t = sgn / (theta.abs() + torch.hypot(theta,
                                                     torch.ones_like(theta)))
                t = torch.where(zero, 0.0, t)
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                arp, arq = a[:, :, p].clone(), a[:, :, q].clone()
                np_ = c[:, None] * arp - s[:, None] * arq
                nq = s[:, None] * arp + c[:, None] * arq
                a[:, :, p], a[:, :, q] = np_, nq
                a[:, p, :], a[:, q, :] = np_, nq
                vrp, vrq = v[:, :, p].clone(), v[:, :, q].clone()
                v[:, :, p] = c[:, None] * vrp - s[:, None] * vrq
                v[:, :, q] = s[:, None] * vrp + c[:, None] * vrq
                a[:, p, p] = app - t * apq
                a[:, q, q] = aqq + t * apq
                a[:, p, q] = 0.0
                a[:, q, p] = 0.0
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    w, V = _normalize(w, v)
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def sym_eig(A: torch.Tensor):
    """(w, V) of a batch of symmetric matrices (..., d, d), d <= 32, f32 or
    f64: w ascending, A = V diag(w) V^T (see the module docstring).

    CUDA kernel: ``csrc/sym_eig.cu`` sym_eig_launch, replacing the
    ``jnp.linalg.eigh`` of limbo_tpu/opt/cmaes.py:93.  Bound by its chain of
    dependent rotations (latency), not by bytes or operations."""
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
                     a.data_ptr(), batch, d, SWEEPS,
                     int(A.dtype == torch.float64), w.data_ptr(),
                     V.data_ptr())
    return w, V
