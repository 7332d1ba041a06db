from limbo_tpu_torch.utils.device import resolve_device
from limbo_tpu_torch.utils.maths import (flatten_params, masked_identity_gram,
                                         safe_sqrt, sq_dist)

__all__ = ["resolve_device", "sq_dist", "safe_sqrt", "masked_identity_gram",
           "flatten_params"]
