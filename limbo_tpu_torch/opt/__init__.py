from limbo_tpu_torch.opt.base import OptResult, clip01
from limbo_tpu_torch.opt.compose import RandomRestarts
from limbo_tpu_torch.opt.gradient import Adam, GradientAscent, Rprop

__all__ = ["OptResult", "clip01", "Rprop", "Adam", "GradientAscent",
           "RandomRestarts"]
