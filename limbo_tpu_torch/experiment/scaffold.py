"""Experiment scaffolding: ``python -m limbo_tpu_torch.cli create --name
myexp`` (port of limbo_tpu/experiment/scaffold.py).

Reference: waf_tools/limbo.py:108 (create_exp) + exp_template.cpp: limbo
generates a ready-to-build experiment directory from a template with
dimensions, noise and budgets chosen on the command line.  Here the
template is a runnable Python script wired to the port (it imports torch
and limbo_tpu_torch only), plus a replication config for the launcher.
The script seeds a ``torch.Generator`` from its replicate number and runs
``BOptimizer`` on its ``DEVICE`` (``create_exp(..., device=)``).
"""

from __future__ import annotations

import json
import os

TEMPLATE = '''"""Experiment: {name} (generated by limbo_tpu_torch.cli create).

Edit `objective` and the config below, then run directly or replicate with:
    python -m limbo_tpu_torch.cli run-local {name}/conf.json
"""

import numpy as np
import torch

from limbo_tpu_torch.acqui import UCB
from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
from limbo_tpu_torch.bo import stats


DIM_IN = {dim_in}
DIM_OUT = {dim_out}
NOISE = {noise}
DEVICE = {device!r}


def objective(x):
    """Return a ({dim_out},) observation for a ({dim_in},) input in [0,1]^d.

    Replace with your simulator / robot / experiment.  Maximized.
    """
    x = np.asarray(x)
    val = -np.sum((x - 0.5) ** 2)
    if NOISE > 0:
        val = val + np.random.normal(scale=NOISE)
    return np.full(DIM_OUT, val)


def main(seed: int = 0):
    bo = BOptimizer(
        acqui=UCB(alpha=0.5),
        init=RandomSampling({samples}),
        stop=(MaxIterations({iterations}),),
        stats=(stats.ConsoleSummary(), stats.Samples(), stats.Observations(),
               stats.BestObservations(), stats.BestAggregatedObservations()),
        res_base_dir=".",
        device=DEVICE,
    )
    np.random.seed(seed)
    generator = torch.Generator(device=DEVICE).manual_seed(seed)
    state = bo.optimize(objective, dim_in=DIM_IN, dim_out=DIM_OUT,
                        generator=generator)
    print("best:", state.best_sample, "->", state.best_observation)
    return state


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
'''

CONF_TEMPLATE = {
    "exps": None,           # filled with [name]
    "nb_runs": 10,
    "res_dir": "results",
    "wall_time": "01:00:00",
    "nb_cores": 1,
}


def create_exp(name: str, base_dir: str = "exp", dim_in: int = 2,
               dim_out: int = 1, noise: float = 0.0, samples: int = 10,
               iterations: int = 190, device: str = "cuda") -> str:
    """Generate <base_dir>/<name>/{<name>.py, conf.json} (limbo.py:108-155);
    the script runs on ``device``."""
    exp_dir = os.path.join(base_dir, name)
    os.makedirs(exp_dir, exist_ok=True)
    script = TEMPLATE.format(name=name, dim_in=dim_in, dim_out=dim_out,
                             noise=noise, samples=samples,
                             iterations=iterations, device=str(device))
    with open(os.path.join(exp_dir, f"{name}.py"), "w") as fh:
        fh.write(script)
    conf = dict(CONF_TEMPLATE)
    conf["exps"] = [name]
    conf["bin_dir"] = exp_dir
    with open(os.path.join(exp_dir, "conf.json"), "w") as fh:
        json.dump(conf, fh, indent=1)
    return exp_dir
