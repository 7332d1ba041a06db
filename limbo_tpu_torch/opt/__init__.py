from limbo_tpu_torch.opt.base import OptResult, clip01
from limbo_tpu_torch.opt.cmaes import Cmaes, reflect01
from limbo_tpu_torch.opt.compose import Chained, ParallelRepeater, RandomRestarts
from limbo_tpu_torch.opt.constrained import AugmentedLagrangian
from limbo_tpu_torch.opt.direct import DirectL
from limbo_tpu_torch.opt.gradient import Adam, GradientAscent, Rprop
from limbo_tpu_torch.opt.nsga2 import Nsga2
from limbo_tpu_torch.opt.search import (GridSearch, RandomPoint, RandomSweep,
                                        argmax_candidates)

__all__ = ["OptResult", "clip01", "Rprop", "Adam", "GradientAscent",
           "GridSearch", "RandomPoint", "RandomSweep", "argmax_candidates",
           "ParallelRepeater", "RandomRestarts", "Chained", "Cmaes",
           "DirectL", "Nsga2", "reflect01", "AugmentedLagrangian"]
