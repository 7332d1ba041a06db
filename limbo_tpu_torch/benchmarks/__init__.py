from limbo_tpu_torch.benchmarks.functions import (
    ALL_FUNCTIONS,
    BRANIN,
    ELLIPSOID,
    GOLDSTEIN_PRICE,
    HARTMANN3,
    HARTMANN6,
    RASTRIGIN,
    SIX_HUMP_CAMEL,
    SPHERE,
    TestFunction,
)
from limbo_tpu_torch.benchmarks.regression_functions import (
    ALL_REGRESSION,
    RegressionFunction,
)
