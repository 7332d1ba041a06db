from limbo_tpu_torch.kernels.base import JITTER, KernelMixin, effective_jitter
from limbo_tpu_torch.kernels.kernels import (Exp, MaternFiveHalves,
                                             MaternThreeHalves, SquaredExpARD)

__all__ = ["JITTER", "KernelMixin", "effective_jitter", "Exp",
           "SquaredExpARD", "MaternThreeHalves", "MaternFiveHalves"]
