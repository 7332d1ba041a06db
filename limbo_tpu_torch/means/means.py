"""Mean-function library: Null, Constant, Data, FunctionARD (port of
limbo_tpu/means/means.py).

A mean is an ``nn.Module`` with its hyperparameters as tensors;
``mean(X)`` maps a (q, d) batch to (q, p) prior means.  Reference
behaviour: src/limbo/mean/{mean,constant,data,null_function,
function_ard}.hpp.  DataMean (the mean of the observations) is refreshed by
``prepare_mean`` whenever the dataset changes.
"""

from __future__ import annotations

import torch

from limbo_tpu_torch.utils.device import resolve_device
from limbo_tpu_torch.utils.modules import HyperModule


class NullMean(HyperModule):
    """m(x) = 0 (limbo mean::NullFunction, null_function.hpp:56)."""

    def __init__(self, dim_out: int = 1):
        super().__init__()
        self.dim_out = dim_out

    @property
    def params(self) -> torch.Tensor:
        return torch.zeros((0,))

    @property
    def params_size(self) -> int:
        return 0

    def with_params(self, p: torch.Tensor) -> "NullMean":
        return self

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.zeros((X.shape[0], self.dim_out), dtype=X.dtype,
                           device=X.device)


class ConstantMean(HyperModule):
    """m(x) = c (limbo mean::Constant, constant.hpp:67; default c = 1)."""

    def __init__(self, value: torch.Tensor, dim_out: int = 1):
        super().__init__()
        self.register_buffer("value", value)
        self.dim_out = dim_out

    @classmethod
    def create(cls, value: float = 1.0, dim_out: int = 1, device="cuda",
               dtype=torch.float32) -> "ConstantMean":
        return cls(torch.tensor(value, dtype=dtype,
                                device=resolve_device(device)), dim_out)

    @property
    def params(self) -> torch.Tensor:
        return self.value.reshape(1)

    @property
    def params_size(self) -> int:
        return 1

    def with_params(self, p: torch.Tensor) -> "ConstantMean":
        return self.replace(value=p[0])

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.value.to(X.dtype).expand(X.shape[0], self.dim_out)


class DataMean(HyperModule):
    """m(x) = mean of the observations (limbo mean::Data, data.hpp:56);
    ``value`` is refreshed by ``prepare_mean``."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.register_buffer("value", value)

    @classmethod
    def create(cls, dim_out: int = 1, device="cuda",
               dtype=torch.float32) -> "DataMean":
        return cls(torch.zeros((dim_out,), dtype=dtype,
                               device=resolve_device(device)))

    @property
    def dim_out(self) -> int:
        return self.value.shape[0]

    @property
    def params(self) -> torch.Tensor:
        return torch.zeros((0,))

    @property
    def params_size(self) -> int:
        return 0

    def with_params(self, p: torch.Tensor) -> "DataMean":
        return self

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.value[None, :].to(X.dtype).expand(X.shape[0],
                                                      self.value.shape[0])


class FunctionARD(HyperModule):
    """Learned affine transform of an inner mean: m(x) = T [inner(x); 1].

    T is (p, p+1), initialised to [I | 0]; the parameter vector is T
    row-major followed by the inner mean's parameters (limbo
    mean::FunctionARD, function_ard.hpp:59-97).
    """

    def __init__(self, inner, tr: torch.Tensor):
        super().__init__()
        self.inner = inner
        self.register_buffer("tr", tr)

    @classmethod
    def create(cls, inner, dim_out: int = 1, device="cuda",
               dtype=None) -> "FunctionARD":
        dev = resolve_device(device)
        if dtype is None:
            # follow the inner mean's dtype (the reference's rule)
            inner_p = inner.params
            dtype = inner_p.dtype if inner_p.numel() else torch.float32
        tr = torch.cat([torch.eye(dim_out, dtype=dtype, device=dev),
                        torch.zeros((dim_out, 1), dtype=dtype, device=dev)],
                       dim=1)
        return cls(inner, tr)

    @property
    def dim_out(self) -> int:
        return self.tr.shape[0]

    @property
    def params(self) -> torch.Tensor:
        return torch.cat([self.tr.reshape(-1),
                          self.inner.params.to(self.tr.device)])

    @property
    def params_size(self) -> int:
        return int(self.tr.numel()) + self.inner.params_size

    def with_params(self, p: torch.Tensor) -> "FunctionARD":
        nt = self.tr.numel()
        tr = p[:nt].reshape(self.tr.shape)
        inner = (self.inner.with_params(p[nt:]) if self.inner.params_size
                 else self.inner)
        return self.replace(inner=inner, tr=tr)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        m = self.inner(X)                                     # (q, p)
        ones = torch.ones((X.shape[0], 1), dtype=m.dtype, device=m.device)
        return torch.cat([m, ones], dim=1) @ self.tr.T.to(m.dtype)


def prepare_mean(mean, Y: torch.Tensor, mask: torch.Tensor):
    """Refresh data-dependent means from the (padded, masked) observations:
    DataMean <- column means over valid rows (limbo gp.mean_observation());
    recursive for FunctionARD; other means unchanged."""
    if isinstance(mean, DataMean):
        n = torch.clamp(torch.sum(mask), min=1.0)
        value = torch.sum(Y * mask[:, None], dim=0) / n
        return mean.replace(value=value.to(mean.value.dtype))
    if isinstance(mean, FunctionARD):
        return mean.replace(inner=prepare_mean(mean.inner, Y, mask))
    return mean
