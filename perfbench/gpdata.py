"""A configuration's data and model, made from the seed on the device.

The configuration file gives the sizes: ``dim`` inputs, ``n`` points at
``capacity`` rows, SquaredExpARD with length-scale ``ell`` in every
dimension, signal variance ``sigma_sq`` and noise variance ``noise``, the
data mean, and observations sin(3 sum x) + ``y_noise`` e.  X is uniform in
[0, 1]^d.  Both come from a ``torch.Generator`` on the device seeded with
the run's seed, which then makes every draw the program takes.
"""

from __future__ import annotations

import math

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_data(cfg: dict, seed: int, device):
    """(generator, X (n, d), Y (n, 1)) in f32 on the device."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    n, d = cfg["n"], cfg["dim"]
    X = torch.rand((n, d), generator=gen, device=dev)
    Y = (objective_rows(X)
         + cfg["y_noise"] * torch.randn((n, 1), generator=gen, device=dev))
    return gen, X, Y


def objective_rows(X: torch.Tensor) -> torch.Tensor:
    """sin(3 sum x) of each row, (n, 1), in X's dtype."""
    return torch.sin(3.0 * X.sum(dim=1, keepdim=True))


def make_model(cfg: dict, device):
    """(kernel, mean) of the program at the configuration's parameters."""
    from limbo_tpu_torch.kernels import SquaredExpARD
    from limbo_tpu_torch.means import DataMean

    kernel = SquaredExpARD.create(dim=cfg["dim"], sigma_sq=cfg["sigma_sq"],
                                  noise=cfg["noise"], device=device)
    kernel = kernel.replace(log_ell=torch.full(
        (cfg["dim"],), math.log(cfg["ell"]), device=device))
    return kernel, DataMean.create(dim_out=1, device=device)


def fit(cfg: dict, kernel, mean, X, Y, device):
    from limbo_tpu_torch.models import gp as gp_mod

    return gp_mod.fit(kernel, mean, X, Y, capacity=cfg["capacity"],
                      device=device)


def build(cfg: dict, gp):
    from limbo_tpu_torch.models import gp as gp_mod

    c = cfg["cache"]
    return gp_mod.QueryCache.build(
        gp, with_Linv=True, qdtype=getattr(torch, c["mirror_dtype"]),
        defer_m=c["defer_m"], lite=c["lite"])


def program_theta(kernel) -> torch.Tensor:
    """The kernel's [log l (d), log sigma] as the program holds them, f64
    on the host."""
    return torch.cat([kernel.log_ell.detach().double().cpu(),
                      kernel.log_sigma.detach().double().cpu().reshape(1)])
