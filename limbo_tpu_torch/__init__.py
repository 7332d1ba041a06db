"""limbo_tpu_torch: the PyTorch / CUDA (Hopper) port of limbo_tpu.

Same components, module layout and numerical contracts as the JAX package
``limbo_tpu`` (the reference), rebuilt on PyTorch: covariance kernels and
means are ``nn.Module``s holding log-space hyperparameter tensors, GP state
and the K^{-1} query cache are dataclasses of tensors, and the Pallas TPU
kernels of the reference are CUDA C++ kernels for sm_90a (``csrc/``), built
at first use and bound with ctypes (``ops/_cuda.py``).

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
without a card it raises unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# GP numerics need true-f32 matmuls (counterpart of limbo_tpu/__init__.py's
# "highest" default precision): TF32's 10-bit mantissa swamps the
# pairwise-distance cancellation |a|^2 + |b|^2 - 2ab for closely spaced
# points and turns dense kernel matrices indefinite.  Both switches are
# set explicitly rather than trusting the library defaults (cuDNN's
# defaults to TF32 on).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from limbo_tpu_torch import acqui, bo, kernels, means, models, ops, opt, utils  # noqa: E402,F401
