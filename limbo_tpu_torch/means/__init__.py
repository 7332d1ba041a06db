from limbo_tpu_torch.means.means import (ConstantMean, DataMean, FunctionARD,
                                         NullMean, prepare_mean)

__all__ = ["NullMean", "ConstantMean", "DataMean", "FunctionARD",
           "prepare_mean"]
