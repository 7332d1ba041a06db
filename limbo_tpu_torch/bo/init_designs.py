"""Initialization designs: seed points before the BO loop starts (port of
limbo_tpu/bo/init_designs.py).

Reference: src/limbo/init/{random_sampling,random_sampling_grid,
grid_sampling,lhs,no_init}.hpp.  A design is called as
``design(generator, dim, dtype)`` and returns the whole (m, d) batch on the
generator's device; the BO driver evaluates the points and seeds the GP.
``count`` is the number of points, known before any draw (the driver sizes
the GP's buffers from it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from limbo_tpu_torch.utils.random import grid_points, random_lhs, random_vectors


@dataclass
class NoInit:
    """No seeding (init/no_init.hpp:54)."""

    def __call__(self, generator, dim: int, dtype=torch.float32
                 ) -> torch.Tensor:
        return torch.zeros((0, dim), dtype=dtype, device=generator.device)

    @property
    def count(self) -> int:
        return 0


@dataclass
class RandomSampling:
    """``samples`` random points (init/random_sampling.hpp:71; default 10):
    U[0,1]^d when bounded, N(0, 10^2) otherwise like limbo's unbounded
    tools::random_vector (random_generator.hpp:141)."""

    samples: int = 10
    bounded: bool = True

    def __call__(self, generator, dim: int, dtype=torch.float32
                 ) -> torch.Tensor:
        return random_vectors(generator, self.samples, dim,
                              bounded=self.bounded, dtype=dtype)

    @property
    def count(self) -> int:
        return self.samples


@dataclass
class RandomSamplingGrid:
    """``samples`` random points snapped onto a ``bins`` grid
    (init/random_sampling_grid.hpp:76; defaults 10 samples, 5 bins)."""

    samples: int = 10
    bins: int = 5

    def __call__(self, generator, dim: int, dtype=torch.float32
                 ) -> torch.Tensor:
        idx = torch.randint(0, self.bins + 1, (self.samples, dim),
                            generator=generator, device=generator.device)
        return idx.to(dtype) / self.bins

    @property
    def count(self) -> int:
        return self.samples


@dataclass
class GridSampling:
    """The full cartesian grid, (bins + 1)^d points (init/grid_sampling.hpp:
    70).  ``count`` is for ``dim`` dimensions, as the reference's."""

    bins: int = 5
    dim: int = 1

    def __call__(self, generator, dim: int, dtype=torch.float32
                 ) -> torch.Tensor:
        return grid_points(self.bins, dim, dtype=dtype,
                           device=generator.device)

    @property
    def count(self) -> int:
        return (self.bins + 1) ** self.dim


@dataclass
class LHS:
    """Latin hypercube sampling (init/lhs.hpp:71; default 10 samples)."""

    samples: int = 10

    def __call__(self, generator, dim: int, dtype=torch.float32
                 ) -> torch.Tensor:
        return random_lhs(generator, self.samples, dim, dtype=dtype)

    @property
    def count(self) -> int:
        return self.samples
