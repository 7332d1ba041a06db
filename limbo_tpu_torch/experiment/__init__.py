from limbo_tpu_torch.experiment.launcher import (
    generate_job_scripts,
    load_conf,
    run_local,
)
from limbo_tpu_torch.experiment.scaffold import create_exp

__all__ = ["create_exp", "generate_job_scripts", "load_conf", "run_local"]
