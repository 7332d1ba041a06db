"""Random designs and point sets (port of limbo_tpu/utils/random.py).

Reference behaviour: src/limbo/tools/random_generator.hpp:130-158
(random_vector_bounded / random_vector / random_lhs).  Every sampler takes
an explicit ``torch.Generator`` where the reference takes a key, and draws
on the generator's device.  torch's Philox streams differ from JAX's
threefry ones, so the draws are held to the reference by their properties;
the deterministic parts (the Halton digits, the grid) are the reference's
arithmetic operation for operation.
"""

from __future__ import annotations

import math

import torch

from limbo_tpu_torch.utils.device import resolve_device


def random_vector(generator: torch.Generator, dim: int, bounded: bool = True,
                  dtype=torch.float32) -> torch.Tensor:
    """One random vector; U[0,1]^dim when bounded, N(0, 10^2) otherwise
    (limbo tools::random_vector, random_generator.hpp:149: the unbounded
    variant draws gaussians with sigma = 10)."""
    return random_vectors(generator, 1, dim, bounded, dtype)[0]


def random_vectors(generator: torch.Generator, n: int, dim: int,
                   bounded: bool = True, dtype=torch.float32) -> torch.Tensor:
    """(n, dim) batch of random vectors."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    if bounded:
        return torch.rand((n, dim), **kw)
    return 10.0 * torch.randn((n, dim), **kw)


def random_lhs(generator: torch.Generator, n: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """Latin hypercube sample of n points in [0,1]^dim (limbo
    tools::random_lhs, random_generator.hpp:158): each of the n strata per
    dimension holds exactly one point, with an independent random
    permutation per dimension."""
    dev = generator.device
    perms = torch.stack([torch.randperm(n, generator=generator, device=dev)
                         for _ in range(dim)], dim=1)
    jitter = torch.rand((n, dim), generator=generator, dtype=dtype,
                        device=dev)
    return (perms.to(dtype) + jitter) / n


_HALTON_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                  59, 61, 67, 71)


def halton(generator: torch.Generator, n: int, dim: int,
           dtype=torch.float32) -> torch.Tensor:
    """Randomized Halton sequence: (n, dim) low-discrepancy points in
    [0,1)^dim with an independent Cramér shift per dimension (mod 1), drawn
    from ``generator``.  Iid uniform beyond the 20-prime table (dim > 20),
    as the reference."""
    dev = generator.device
    if dim > len(_HALTON_PRIMES):
        return torch.rand((n, dim), generator=generator, dtype=dtype,
                          device=dev)
    shift = torch.rand((dim,), generator=generator, dtype=dtype, device=dev)
    return _shifted_halton(n, shift)


def _shifted_halton(n: int, shift: torch.Tensor) -> torch.Tensor:
    """The first n Halton points in the first len(shift) <= 20 prime bases,
    shifted by ``shift`` mod 1, in shift's dtype and on its device."""
    dtype, dev = shift.dtype, shift.device
    i0 = torch.arange(1, n + 1, device=dev)
    cols = []
    for b in _HALTON_PRIMES[:shift.shape[0]]:
        digits = max(1, int(math.ceil(math.log(n + 1) / math.log(b))))
        x = torch.zeros((n,), dtype=dtype, device=dev)
        f = 1.0 / b
        idx = i0
        for _ in range(digits):
            x = x + (idx % b).to(dtype) * f
            idx = idx // b
            f = f / b
        cols.append(x)
    return torch.remainder(torch.stack(cols, dim=1) + shift[None, :], 1.0)


def grid_points(bins: int, dim: int, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Full cartesian grid with (bins + 1) points per dimension in [0,1]^dim
    (limbo init::GridSampling, init/grid_sampling.hpp:70), ((bins+1)^dim,
    dim), first dimension slowest.  The axis is the reference's linspace
    as it computes it: i * (1 / bins), then exactly 1."""
    dev = resolve_device(device)
    axis = torch.cat([torch.arange(bins, dtype=dtype, device=dev)
                      * (1.0 / bins),
                      torch.ones((1,), dtype=dtype, device=dev)])
    mesh = torch.meshgrid(*([axis] * dim), indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)
