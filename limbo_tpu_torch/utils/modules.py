"""Functional updates of the port's hyperparameter modules.

Covariance kernels and means are ``nn.Module``s whose hyperparameters are
registered tensors (buffers).  Like the reference's immutable dataclasses
(``.replace``), an update returns a new module and leaves the old one as it
was, so a gradient can flow from a parameter vector through ``with_params``.
"""

from __future__ import annotations

import copy

from torch import nn


class HyperModule(nn.Module):
    """An ``nn.Module`` with the reference's ``replace(**fields)``."""

    def replace(self, **fields):
        """A shallow copy with the named tensors or submodules swapped."""
        new = copy.copy(self)
        new._buffers = dict(self._buffers)
        new._modules = dict(self._modules)
        new._parameters = dict(self._parameters)
        for name, value in fields.items():
            if name not in new._buffers and name not in new._modules:
                raise AttributeError(f"{type(self).__name__} has no "
                                     f"hyperparameter {name!r}")
            setattr(new, name, value)
        return new
