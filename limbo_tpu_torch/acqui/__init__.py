from limbo_tpu_torch.acqui.acqui import (EI, GP_UCB, UCB, DistanceToTarget,
                                         FirstElem, MeanAggregator)

__all__ = ["UCB", "GP_UCB", "EI", "FirstElem", "MeanAggregator",
           "DistanceToTarget"]
