"""Custom statistics tutorial (the port of tutorials/statistics.py, after
src/tutorials/statistics.cpp): define a new stats writer and attach it to
the BO loop; it writes worst_observations.dat under the run's result
directory (``res_base_dir``/hostname_date_pid).

    python3 tutorials/torch/statistics.py              # on the card
    main(device="cpu", iterations=3)                   # on the CPU
"""

import numpy as np
import torch

from limbo_tpu_torch.bo import BOptimizer, MaxIterations
from limbo_tpu_torch.bo.stats import StatBase
from limbo_tpu_torch.models import gp as gp_mod


class WorstObservation(StatBase):
    """Example custom stat: log the worst observation so far."""

    filename = "worst_observations.dat"

    def __call__(self, bo, state):
        with torch.no_grad():
            obs = gp_mod.observations(state.gp)
            agg = state.aggregator(obs).cpu().numpy()
        worst = obs[int(np.argmin(agg))].cpu().numpy()
        self._log(bo, f"{state.iteration} "
                  + " ".join(f"{v:.6g}" for v in worst))


def eval_fn(x):
    return np.array([-np.sum((np.asarray(x) - 0.5) ** 2)])


def main(device="cuda", iterations=15, res_base_dir=".", seed=0):
    bo = BOptimizer(stop=(MaxIterations(iterations),),
                    stats=(WorstObservation(),), res_base_dir=res_base_dir,
                    device=device)
    state = bo.optimize(
        eval_fn, 2, generator=torch.Generator(device=bo.device).manual_seed(
            seed))
    print("done; stats in", bo.res_dir)
    return state, bo.res_dir


if __name__ == "__main__":
    main()
