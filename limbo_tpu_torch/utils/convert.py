"""Carry a GP and its query cache across from the JAX package.

The input is a dict of numpy arrays keyed by the pytree paths that
``jax.tree_util.tree_flatten_with_path`` yields for the JAX package's ``GP``
and ``QueryCache`` (what its serializer writes): ``.kernel/.log_ell``,
``.mean/.value``, ``.x``, ``.y``, ``.n``, ``.L``, ``.alpha`` for a GP, and
``.Kinv``, ``.K``, ``.Linv``, ``.Kinv_q``, ``.P``, ``.base_n``, ``.ay``,
``.u_ones`` for a cache.  Integer scalars (``n``, ``base_n``) come back as
Python ints; bf16 arrays (the query mirror) keep their dtype.  A GP after
hyperparameter learning carries its learned parameters in the same
buffers, and a GP factored by the blocked Cholesky its ``L`` like any other.

``to_inits`` turns the reference's restart perturbations (drawn from its
PRNG key, which torch cannot reproduce) into the starts that the port's
deterministic ``ParallelRepeater.from_inits`` and ``_multi_start(...,
pert=)`` take.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from limbo_tpu_torch.models.gp import GP, QueryCache
from limbo_tpu_torch.utils.device import resolve_device

_GP_ARRAYS = ("x", "y", "L", "alpha")
_CACHE_ARRAYS = ("Kinv", "K", "Linv", "Kinv_q", "P", "ay", "u_ones")


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor on `device`."""
    a = np.array(a, order="C")                 # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _path(key: str):
    """'.kernel/.log_ell' -> ['kernel', 'log_ell']."""
    return [p.lstrip(".") for p in key.split("/")]


def to_module(module, prefix: str, arrays: dict, device):
    """A copy of `module` with every buffer named under `prefix` in
    `arrays` replaced (nested modules such as FunctionARD's inner mean
    follow the path)."""
    module = copy.deepcopy(module)
    for key, a in arrays.items():
        parts = _path(key)
        if parts[0] != prefix:
            continue
        owner = module
        for name in parts[1:-1]:
            owner = getattr(owner, name)
        leaf = parts[-1]
        if leaf not in owner._buffers:
            raise KeyError(f"{key}: {type(owner).__name__} has no "
                           f"hyperparameter {leaf!r}")
        setattr(owner, leaf, to_tensor(a, device))
    return module


def to_gp(arrays: dict, kernel, mean, device="cuda") -> GP:
    """The port's GP from the JAX GP's flattened arrays.  `kernel` and
    `mean` are port modules of the same classes (their hyperparameters are
    overwritten from the arrays in copies)."""
    dev = resolve_device(device)
    fields = {k: to_tensor(arrays["." + k], dev) for k in _GP_ARRAYS}
    return GP(kernel=to_module(kernel, "kernel", arrays, dev),
              mean=to_module(mean, "mean", arrays, dev),
              n=int(arrays[".n"]), **fields)


def to_cache(arrays: dict, device="cuda") -> QueryCache:
    """The port's QueryCache from the JAX cache's flattened arrays (absent
    optional fields stay None)."""
    dev = resolve_device(device)
    fields = {k: to_tensor(arrays["." + k], dev) for k in _CACHE_ARRAYS
              if "." + k in arrays}
    if ".base_n" in arrays:
        fields["base_n"] = int(arrays[".base_n"])
    return QueryCache(**fields)


def to_inits(init, pert, device="cuda") -> torch.Tensor:
    """(R, P) starts init + pert from the reference's (P,) start and its
    (R, P) uniform perturbations, both numpy arrays.  The reference draws
    them as ``uniform(split(key, R + 1)[0], (R, P), -eps, eps)``
    (ParallelRepeater, limbo_tpu/opt/compose.py:32-36) or from the first
    of ``split(key, restarts + 1)`` (_multi_start, which then zeroes row
    0, limbo_tpu/models/hp_opt.py:82-86)."""
    dev = resolve_device(device)
    return to_tensor(init, dev)[None, :] + to_tensor(pert, dev)
